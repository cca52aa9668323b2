"""Vector-database writers: Pinecone, Qdrant, Chroma (reference:
src/connectors/data_storage/pinecone.rs 746, qdrant.rs 538, chroma.rs 494).

All three are REST APIs, so no client libraries: each writer maintains the
live vector set — diff>0 upserts (id, vector, metadata/document), diff<0
deletes by id — over plain HTTP with an injectable transport
(`_http(method, url, payload, headers) -> dict`) for tests.

Row ids default to the engine key (stable across updates, so an updated
row upserts in place); `id_column` overrides.

The port of ``pathway_tpu/io/vector_writers.py``.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Any, Iterable

import numpy as np

from ..engine.types import unwrap_row
from ..internals import parse_graph as pg
from ..internals.table import Table


def _default_http(method: str, url: str, payload: dict | None,
                  headers: dict) -> dict:
    req = urllib.request.Request(
        url,
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **headers},
        method=method,
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        body = resp.read()
    return json.loads(body) if body.strip() else {}


def _vec_list(v) -> list[float]:
    return [float(x) for x in np.asarray(v, np.float32).reshape(-1)]


class _VectorWriterBase:
    """Splits each engine batch into upserts and deletes keyed by id."""

    def __init__(self, colnames_hint=None, *, vector_column: str,
                 id_column: str | None, metadata_columns, _http):
        self.vector_column = vector_column
        self.id_column = id_column
        self.metadata_columns = list(metadata_columns or [])
        self._http = _http or _default_http

    def write_batch(self, time_, colnames, updates) -> None:
        colnames = list(colnames)
        vi = colnames.index(self.vector_column)
        ii = colnames.index(self.id_column) if self.id_column else None
        upserts, deletes = [], []
        for key, row, diff in updates:
            vals = unwrap_row(row)
            rid = str(vals[ii]) if ii is not None else str(key)
            if diff > 0:
                meta = {
                    c: _plain(vals[colnames.index(c)])
                    for c in self.metadata_columns
                }
                upserts.append((rid, _vec_list(vals[vi]), meta))
            else:
                deletes.append(rid)
        if deletes:
            self._delete(deletes)
        if upserts:
            self._upsert(upserts)

    def close(self) -> None:
        pass

    def _upsert(self, items):
        raise NotImplementedError

    def _delete(self, ids):
        raise NotImplementedError


def _plain(v):
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    return str(v)


class PineconeWriter(_VectorWriterBase):
    def __init__(self, *, index_host: str, api_key: str = "",
                 namespace: str = "", **kw):
        super().__init__(**kw)
        self.base = index_host.rstrip("/")
        if not self.base.startswith("http"):
            self.base = f"https://{self.base}"
        self.namespace = namespace
        self.headers = {"Api-Key": api_key}

    def _upsert(self, items):
        self._http(
            "POST", f"{self.base}/vectors/upsert",
            {
                "vectors": [
                    {"id": i, "values": v, "metadata": m}
                    for i, v, m in items
                ],
                "namespace": self.namespace,
            },
            self.headers,
        )

    def _delete(self, ids):
        self._http(
            "POST", f"{self.base}/vectors/delete",
            {"ids": ids, "namespace": self.namespace}, self.headers,
        )


class QdrantWriter(_VectorWriterBase):
    def __init__(self, *, url: str, collection: str, api_key: str = "", **kw):
        super().__init__(**kw)
        self.base = url.rstrip("/")
        self.collection = collection
        self.headers = {"api-key": api_key} if api_key else {}

    def _upsert(self, items):
        self._http(
            "PUT",
            f"{self.base}/collections/{self.collection}/points?wait=true",
            {
                "points": [
                    {"id": i, "vector": v, "payload": m} for i, v, m in items
                ]
            },
            self.headers,
        )

    def _delete(self, ids):
        self._http(
            "POST",
            f"{self.base}/collections/{self.collection}/points/delete?wait=true",
            {"points": ids}, self.headers,
        )


class ChromaWriter(_VectorWriterBase):
    def __init__(self, *, url: str, collection_id: str,
                 document_column: str | None = None, **kw):
        super().__init__(**kw)
        self.base = url.rstrip("/")
        self.collection_id = collection_id
        self.document_column = document_column

    def write_batch(self, time_, colnames, updates) -> None:
        # chroma upserts carry documents alongside embeddings
        self._colnames = list(colnames)
        super().write_batch(time_, colnames, updates)

    def _upsert(self, items):
        payload = {
            "ids": [i for i, _v, _m in items],
            "embeddings": [v for _i, v, _m in items],
            "metadatas": [m for _i, _v, m in items],
        }
        if self.document_column:
            payload["documents"] = [
                m.get(self.document_column) for _i, _v, m in items
            ]
        self._http(
            "POST",
            f"{self.base}/api/v1/collections/{self.collection_id}/upsert",
            payload, {},
        )

    def _delete(self, ids):
        self._http(
            "POST",
            f"{self.base}/api/v1/collections/{self.collection_id}/delete",
            {"ids": ids}, {},
        )


def _make_write(writer_cls, entitlement: str):
    def write(table: Table, *, vector_column: str = "vector",
              id_column: str | None = None,
              metadata_columns: Iterable[str] | None = None,
              **settings) -> None:
        from ..internals.config import _check_entitlements

        _check_entitlements(entitlement)
        writer = writer_cls(
            vector_column=vector_column, id_column=id_column,
            metadata_columns=metadata_columns,
            _http=settings.pop("_http", None), **settings,
        )
        pg.new_output_node(
            "output", [table], colnames=table.column_names(), writer=writer
        )

    return write


write_pinecone = _make_write(PineconeWriter, "pinecone")
write_qdrant = _make_write(QdrantWriter, "qdrant")
write_chroma = _make_write(ChromaWriter, "chromadb")
