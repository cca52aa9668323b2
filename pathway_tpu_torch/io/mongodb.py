"""MongoDB connectors (reference: python/pathway/io/mongodb/__init__.py over
src/connectors/data_storage/mongodb.rs, 699 LoC).

write(): rows upsert/delete into a collection keyed by the engine row key
(snapshot semantics).  read(): change-stream-free polling reader over a
collection with per-document versions, for parity testing; production CDC
rides debezium (pw.io.debezium).  The client seam accepts injected fakes.

The port of ``pathway_tpu/io/mongodb.py``."""

from __future__ import annotations

import time as _time
from typing import Any

from ..internals.datasource import DataSource
from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from ..internals.value import ref_scalar
from ._utils import add_output_node, coerce_value, make_input_table
from ..internals.config import _check_entitlements


def _make_client(connection_string: str, injected=None):
    if injected is not None:
        return injected
    try:
        import pymongo
    except ImportError as exc:
        raise ImportError(
            "pw.io.mongodb requires pymongo (or an injected client for tests)"
        ) from exc
    return pymongo.MongoClient(connection_string)


class _MongoWriter:
    def __init__(self, connection_string: str, database: str, collection: str,
                 _client=None):
        self.connection_string = connection_string
        self.database = database
        self.collection = collection
        self._client = _client

    def _coll(self):
        if self._client is None:
            self._client = _make_client(self.connection_string)
        return self._client[self.database][self.collection]

    def write_batch(self, time_, colnames, updates) -> None:
        from ..engine.types import unwrap_row
        from ._utils import _jsonable

        if not updates:
            return
        coll = self._coll()
        for key, row, diff in updates:
            doc_id = str(int(key))
            if diff > 0:
                doc = {
                    c: _jsonable(v) for c, v in zip(colnames, unwrap_row(row))
                }
                doc["_id"] = doc_id
                coll.replace_one({"_id": doc_id}, doc, upsert=True)
            else:
                coll.delete_one({"_id": doc_id})

    def close(self) -> None:
        pass


def write(table: Table, connection_string: str, database: str,
          collection: str, **kwargs) -> None:
    add_output_node(
        table,
        _MongoWriter(
            connection_string, database, collection,
            _client=kwargs.get("_client"),
        ),
    )


class MongoSource(DataSource):
    """Polling reader: emits inserts/updates/deletes as Z-set diffs by
    diffing collection snapshots on `_id` (append-friendly parity tier; the
    reference's Rust reader follows change streams)."""

    def __init__(self, connection_string: str, database: str, collection: str,
                 schema: SchemaMetaclass, poll_interval_s: float = 1.0,
                 live: bool = True, _client=None):
        self.connection_string = connection_string
        self.database = database
        self.collection = collection
        self.schema = schema
        self.poll_interval_s = poll_interval_s
        self._live = live
        self._client = _client
        self._known: dict[str, tuple] = {}
        self._last_poll = 0.0

    def is_live(self) -> bool:
        return self._live

    def _coll(self):
        if self._client is None:
            self._client = _make_client(self.connection_string)
        return self._client[self.database][self.collection]

    def _snapshot_events(self) -> list:
        colnames = self.schema.column_names()
        dtypes = self.schema.dtypes()
        events = []
        seen: set[str] = set()
        for doc in self._coll().find({}):
            doc_id = str(doc.get("_id"))
            seen.add(doc_id)
            row = tuple(coerce_value(doc.get(c), dtypes[c]) for c in colnames)
            old = self._known.get(doc_id)
            if old == row:
                continue
            key = ref_scalar("mongo", doc_id)
            if old is not None:
                events.append((0, key, old, -1))
            events.append((0, key, row, 1))
            self._known[doc_id] = row
        for doc_id in list(self._known):
            if doc_id not in seen:
                key = ref_scalar("mongo", doc_id)
                events.append((0, key, self._known.pop(doc_id), -1))
        return events

    def static_events(self) -> list:
        return self._snapshot_events()

    def poll(self):
        now = _time.monotonic()
        if now - self._last_poll < self.poll_interval_s:
            return []
        self._last_poll = now
        return self._snapshot_events()


def read(connection_string: str, database: str, collection: str, *,
         schema: SchemaMetaclass, mode: str = "streaming",
         poll_interval_s: float = 1.0, **kwargs) -> Table:
    _check_entitlements("mongodb-oplog-reader")
    src = MongoSource(
        connection_string, database, collection, schema,
        poll_interval_s=poll_interval_s, live=(mode == "streaming"),
        _client=kwargs.get("_client"),
    )
    return make_input_table(schema, src, name=f"mongodb:{collection}", persistent_id=kwargs.get("persistent_id"))
