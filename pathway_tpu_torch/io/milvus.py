"""Milvus sink (reference: python/pathway/io/milvus/__init__.py:138).

Each diff>0 upserts an entity, each diff<0 deletes by primary key.  Uses
Milvus' RESTful v2 API (`/v2/vectordb/entities/{upsert,delete}`) rather
than pymilvus, behind the shared injectable `_http` transport seam.
Deletes are applied before upserts within a batch (reference semantics) so
retract+insert pairs of the same key land as an update.

The port of ``pathway_tpu/io/milvus.py``.
"""

from __future__ import annotations

import json
from typing import Any, Iterable

from ..engine.types import unwrap_row
from ..internals import parse_graph as pg
from ..internals.expression import ColumnReference
from ..internals.table import Table
from .vector_writers import _default_http, _plain, _vec_list
from ..internals.config import _check_entitlements


class _MilvusWriter:
    def __init__(self, uri: str, collection: str, *, primary_key: str,
                 token: str | None, batch_size: int, _http):
        self.base_url = uri.rstrip("/")
        self.collection = collection
        self.primary_key = primary_key
        self.batch_size = batch_size
        self.headers = {"Authorization": f"Bearer {token}"} if token else {}
        self._http = _http or _default_http

    def _post(self, op: str, payload: dict) -> None:
        resp = self._http(
            "POST", f"{self.base_url}/v2/vectordb/entities/{op}",
            payload, self.headers,
        )
        code = resp.get("code") if isinstance(resp, dict) else None
        if code not in (None, 0, 200):
            raise RuntimeError(
                f"milvus {op} failed: {resp.get('message', resp)}"
            )

    def write_batch(self, time_, colnames, updates) -> None:
        colnames = list(colnames)
        pi = colnames.index(self.primary_key)
        upserts, delete_ids = [], []
        for _key, row, diff in updates:
            vals = unwrap_row(row)
            pk = vals[pi]
            # the delete path str()s the key into a filter expression, so
            # only types with an exact filter-grammar rendering are sound
            # primary keys (bool/float/None render as tokens
            # the grammar won't match, silently dropping the retraction)
            if pk is None or isinstance(pk, (bool, float)) or not isinstance(
                    pk, (int, str)):
                raise ValueError(
                    f"milvus primary key {self.primary_key!r} must be a "
                    f"non-null int or str, got {type(pk).__name__}: {pk!r}"
                )
            if diff > 0:
                ent: dict[str, Any] = {}
                for i, c in enumerate(colnames):
                    v = vals[i]
                    if hasattr(v, "__len__") and not isinstance(
                            v, (str, bytes, list, dict)):
                        ent[c] = _vec_list(v)  # ndarray → vector field
                    elif isinstance(v, (list, dict)):
                        ent[c] = v
                    else:
                        ent[c] = _plain(v)
                upserts.append(ent)
            else:
                delete_ids.append(pk)
        if delete_ids:
            ids = ", ".join(
                json.dumps(i) if isinstance(i, str) else str(i)
                for i in delete_ids
            )
            self._post("delete", {
                "collectionName": self.collection,
                "filter": f"{self.primary_key} in [{ids}]",
            })
        for i in range(0, len(upserts), self.batch_size):
            self._post("upsert", {
                "collectionName": self.collection,
                "data": upserts[i:i + self.batch_size],
            })

    def close(self) -> None:
        pass


def write(table: Table, uri: str, collection_name: str, *,
          primary_key: ColumnReference, batch_size: int = 256,
          token: str | None = None, name: str | None = None,
          sort_by: Iterable[ColumnReference] | None = None,
          _http=None) -> None:
    """Keep a Milvus collection in sync with `table`."""
    _check_entitlements("milvusdb")
    if not isinstance(primary_key, ColumnReference):
        raise ValueError("primary_key must be a column reference")
    if primary_key._name not in table.column_names():
        raise ValueError(
            f"primary_key column {primary_key._name!r} does not belong to "
            "the written table"
        )
    writer = _MilvusWriter(
        uri, collection_name, primary_key=primary_key._name, token=token,
        batch_size=batch_size, _http=_http,
    )
    pg.new_output_node(
        "output", [table], colnames=table.column_names(), writer=writer,
    )
