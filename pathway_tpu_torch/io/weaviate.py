"""Weaviate sink (reference: python/pathway/io/weaviate/__init__.py:18).

Keeps a Weaviate collection in sync with the table: diff>0 upserts an
object (PUT by deterministic UUID), diff<0 deletes it.  Weaviate's API is
plain REST (`/v1/objects`, `/v1/batch/objects`), so no client library; the
transport is the same injectable `_http` seam as io/vector_writers.py.

Object UUIDs are uuid5 over the primary-key value (or the engine key), so
an update to the same key overwrites in place.

The port of ``pathway_tpu/io/weaviate.py``.
"""

from __future__ import annotations

import urllib.error
import uuid
from typing import Any, Iterable

import numpy as np

from ..engine.types import unwrap_row
from ..internals import parse_graph as pg
from ..internals.expression import ColumnReference
from ..internals.table import Table
from .vector_writers import _default_http, _plain, _vec_list
from ..internals.config import _check_entitlements

_NS = uuid.UUID("8a6e1f44-20c1-4b7e-9a08-7f31bb44a1ce")


def _uuid_for(value: Any) -> str:
    return str(uuid.uuid5(_NS, repr(value)))


class _WeaviateWriter:
    def __init__(self, collection: str, *, primary_key: str | None,
                 vector: str | None, base_url: str, api_key: str | None,
                 headers: dict | None, batch_size: int, _http):
        self.collection = collection
        self.primary_key = primary_key
        self.vector = vector
        self.base_url = base_url.rstrip("/")
        self.batch_size = batch_size
        self.headers = dict(headers or {})
        if api_key:
            self.headers["Authorization"] = f"Bearer {api_key}"
        self._http = _http or _default_http

    def write_batch(self, time_, colnames, updates) -> None:
        colnames = list(colnames)
        pi = colnames.index(self.primary_key) if self.primary_key else None
        vi = colnames.index(self.vector) if self.vector else None
        prop_cols = [
            (i, c) for i, c in enumerate(colnames)
            if c not in (self.primary_key, self.vector)
        ]
        upserts, deletes = [], []
        for key, row, diff in updates:
            vals = unwrap_row(row)
            oid = _uuid_for(vals[pi] if pi is not None else key)
            if diff > 0:
                obj = {
                    "class": self.collection,
                    "id": oid,
                    "properties": {c: _plain(vals[i]) for i, c in prop_cols},
                }
                if vi is not None and vals[vi] is not None:
                    obj["vector"] = _vec_list(vals[vi])
                upserts.append(obj)
            else:
                deletes.append(oid)
        # deletes first so an update (retract+insert of one key) lands as
        # the new object
        for oid in deletes:
            try:
                self._http(
                    "DELETE",
                    f"{self.base_url}/v1/objects/{self.collection}/{oid}",
                    None, self.headers,
                )
            except urllib.error.HTTPError as exc:
                if exc.code != 404:  # already absent: retraction is a no-op
                    raise
        for i in range(0, len(upserts), self.batch_size):
            resp = self._http(
                "POST", f"{self.base_url}/v1/batch/objects",
                {"objects": upserts[i:i + self.batch_size]}, self.headers,
            )
            # weaviate reports per-object failures inside a 200 body
            if isinstance(resp, list):
                for obj in resp:
                    errors = (obj.get("result", {}) or {}).get(
                        "errors") if isinstance(obj, dict) else None
                    if errors:
                        raise RuntimeError(
                            f"weaviate batch insert failed for "
                            f"{obj.get('id')}: {errors}"
                        )

    def close(self) -> None:
        pass


def _colname(ref, table: Table, role: str) -> str | None:
    if ref is None:
        return None
    if not isinstance(ref, ColumnReference):
        raise ValueError(f"{role} must be a column reference")
    if ref._name not in table.column_names():
        raise ValueError(
            f"{role} column {ref._name!r} does not belong to the written "
            "table"
        )
    return ref._name


def write(table: Table, collection_name: str, *,
          primary_key: ColumnReference | None = None,
          vector: ColumnReference | None = None,
          http_host: str = "localhost", http_port: int = 8080,
          http_secure: bool = False, api_key: str | None = None,
          headers: dict[str, str] | None = None, batch_size: int = 100,
          concurrency: int = 8, name: str | None = None,
          sort_by: Iterable[ColumnReference] | None = None,
          _http=None) -> None:
    """Keep a Weaviate collection in sync with `table`."""
    _check_entitlements("weaviate")
    scheme = "https" if http_secure else "http"
    writer = _WeaviateWriter(
        collection_name,
        primary_key=_colname(primary_key, table, "primary_key"),
        vector=_colname(vector, table, "vector"),
        base_url=f"{scheme}://{http_host}:{http_port}",
        api_key=api_key, headers=headers, batch_size=batch_size,
        _http=_http,
    )
    pg.new_output_node(
        "output", [table], colnames=table.column_names(), writer=writer,
    )
