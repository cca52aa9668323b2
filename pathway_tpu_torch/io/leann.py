"""LEANN vector-index sink (reference: python/pathway/io/leann/__init__.py:135).

Observes every minibatch and rebuilds the index from the current snapshot of
the table (LEANN has no incremental update — reference behavior).  When the
`leann` package is installed it is used directly; otherwise a native
dependency-free index is written with the same file contract (a set of files
sharing `index_path` as prefix): `<prefix>.meta.json` with the document
manifest and `<prefix>.bm25.pkl`, a pickled lexical index loadable with
`load_native_index` for search.  Text/metadata columns must be `str`
(validated at write() time, reference parity); empty texts are skipped with
a warning.

The port of ``pathway_tpu/io/leann.py``.  Without the
``leann`` package the first rebuild logs that the native index is
written instead.
"""

from __future__ import annotations

import json
import logging
import pickle
from pathlib import Path
from typing import Any, Iterable, Literal

from ..engine.types import unwrap_row
from ..internals import dtype as dt
from ..internals import parse_graph as pg
from ..internals.expression import ColumnReference
from ..internals.table import Table
from ..internals.config import _check_entitlements

_log = logging.getLogger("pathway_tpu_torch.io.leann")


def _leann_or_none():
    try:
        import leann  # type: ignore

        return leann
    except ImportError:
        return None


class _LeannWriter:
    def __init__(self, index_path, text_column: str,
                 metadata_columns: list[str], backend_name: str,
                 embedding_options: dict):
        self.index_path = Path(index_path)
        self.text_column = text_column
        self.metadata_columns = metadata_columns
        self.backend_name = backend_name
        self.embedding_options = embedding_options
        self.documents: dict[Any, dict[str, Any]] = {}
        self._skipped = 0
        self._native_logged = False

    def write_batch(self, time_, colnames, updates) -> None:
        colnames = list(colnames)
        ti = colnames.index(self.text_column)
        mi = [(c, colnames.index(c)) for c in self.metadata_columns]
        dirty = False
        for key, row, diff in updates:
            if diff <= 0:
                dirty |= self.documents.pop(key, None) is not None
                continue
            vals = unwrap_row(row)
            text = vals[ti]
            if not text or not str(text).strip():
                self._skipped += 1
                _log.warning(
                    "leann: skipping row with empty text (key=%s); "
                    "total skipped: %d", key, self._skipped,
                )
                continue
            self.documents[key] = {
                "text": str(text),
                "metadata": {c: vals[i] for c, i in mi},
            }
            dirty = True
        if dirty:
            self._rebuild()

    def _rebuild(self) -> None:
        leann = _leann_or_none()
        if leann is not None:
            builder = leann.LeannBuilder(
                backend_name=self.backend_name, **self.embedding_options,
            )
            for doc in self.documents.values():
                builder.add_text(doc["text"], metadata=doc["metadata"])
            builder.build_index(str(self.index_path))
            return
        # native fallback: manifest + pickled lexical index, same
        # prefix-file contract as the leann package
        if not self._native_logged:
            self._native_logged = True
            _log.info(
                "leann: the leann package is not installed; writing the "
                "native BM25 index at %s", self.index_path,
            )
        self.index_path.parent.mkdir(parents=True, exist_ok=True)
        docs = list(self.documents.values())
        meta = {
            "backend_name": self.backend_name,
            "num_documents": len(docs),
            "format": "pathway_tpu-native-bm25",
        }
        (self.index_path.with_suffix(self.index_path.suffix + ".meta.json")
         ).write_text(json.dumps(meta))
        from ..stdlib.indexing.inner_index import TantivyBM25

        index = TantivyBM25()
        for i, doc in enumerate(docs):
            index.add(i, doc["text"], doc["metadata"])
        with open(str(self.index_path) + ".bm25.pkl", "wb") as f:
            pickle.dump({"index": index, "documents": docs}, f)

    def close(self) -> None:
        pass


def load_native_index(index_path) -> dict:
    """Load the native-fallback index written by `write` (tests/serving)."""
    with open(str(index_path) + ".bm25.pkl", "rb") as f:
        return pickle.load(f)


def write(table: Table, index_path, text_column: ColumnReference, *,
          metadata_columns: list[ColumnReference] | None = None,
          backend_name: Literal["hnsw", "diskann"] = "hnsw",
          embedding_mode: str | None = None,
          embedding_model: str | None = None,
          embedding_options: dict | None = None,
          name: str | None = None) -> None:
    """Write the table to a LEANN index rebuilt on every minibatch."""
    _check_entitlements("leann")
    dtypes = table.schema.dtypes()

    def _check_str(ref, role):
        if not isinstance(ref, ColumnReference):
            raise ValueError(f"{role} must be a column reference")
        d = dtypes.get(ref._name, dt.ANY).strip_optional()
        if d not in (dt.STR, dt.ANY):
            raise ValueError(
                f"{role} column {ref._name!r} must be of type str, got {d}"
            )
        return ref._name

    text = _check_str(text_column, "text_column")
    metas = [_check_str(m, "metadata_columns") for m in metadata_columns or []]
    opts = dict(embedding_options or {})
    if embedding_mode:
        opts["embedding_mode"] = embedding_mode
    if embedding_model:
        opts["embedding_model"] = embedding_model
    pg.new_output_node(
        "output", [table], colnames=table.column_names(),
        writer=_LeannWriter(index_path, text, metas, backend_name, opts),
    )
