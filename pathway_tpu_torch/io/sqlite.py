"""SQLite connector (reference: src/connectors/data_storage/sqlite.rs, 1,698
LoC).  Reads are snapshot-diffed: the table is polled and compared against
the previous snapshot, emitting Z-set deltas — updates and deletes in the
database flow through as retract+insert pairs.

The port of ``pathway_tpu/io/sqlite.py``.
"""

from __future__ import annotations

import logging
import sqlite3
import time
from typing import Any

from ..engine.types import unwrap_row
from ..internals import parse_graph as pg
from ..internals.datasource import DataSource
from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from ..internals.value import ref_scalar
from ._utils import coerce_value, make_input_table

_log = logging.getLogger("pathway_tpu_torch.io.sqlite")


def _q(ident: str) -> str:
    """Quote an SQL identifier (keywords, spaces)."""
    return '"' + ident.replace('"', '""') + '"'


class SqliteSnapshotSource(DataSource):
    def __init__(self, path: str, table_name: str, schema: SchemaMetaclass,
                 poll_interval_s: float = 0.5, mode: str = "streaming"):
        self.path = path
        self.table_name = table_name
        self.schema = schema
        self.poll_interval_s = poll_interval_s
        self.mode = mode
        self._snapshot: dict[Any, tuple] = {}
        self._last_poll = 0.0
        self._first = True
        self._error_logged = False

    def is_live(self) -> bool:
        return self.mode == "streaming"

    def _read_rows(self) -> dict[Any, tuple]:
        colnames = self.schema.column_names()
        dtypes = self.schema.dtypes()
        declared_pk = self.schema.primary_key_columns()
        cols_sql = ", ".join(_q(c) for c in colnames)
        con = sqlite3.connect(self.path)
        try:
            cur = con.execute(
                f"SELECT rowid, {cols_sql} FROM {_q(self.table_name)}"
            )
            out: dict[Any, tuple] = {}
            for raw in cur.fetchall():
                rowid, *vals = raw
                d = dict(zip(colnames, vals))
                row = tuple(coerce_value(d[c], dtypes[c]) for c in colnames)
                if declared_pk:
                    key = ref_scalar(*[d[c] for c in declared_pk])
                    if key in out and not self._error_logged:
                        _log.warning(
                            "duplicate primary key in %s.%s; keeping the last "
                            "row per key", self.path, self.table_name,
                        )
                        self._error_logged = True
                else:
                    # no declared pk: rowid keeps duplicate rows distinct
                    key = ref_scalar("#rowid", rowid)
                out[key] = row
            return out
        finally:
            con.close()

    def _diff(self) -> list:
        new = self._read_rows()
        events = []
        for key, row in new.items():
            old = self._snapshot.get(key)
            if old is None:
                events.append((0, key, row, 1))
            elif old != row:
                events.append((0, key, old, -1))
                events.append((0, key, row, 1))
        for key, row in self._snapshot.items():
            if key not in new:
                events.append((0, key, row, -1))
        self._snapshot = new
        self._error_logged = False or self._error_logged
        return events

    def static_events(self) -> list:
        if self.mode == "streaming":
            return []
        return self._diff()

    def poll(self):
        now = time.monotonic()
        if not self._first and now - self._last_poll < self.poll_interval_s:
            return []
        self._first = False
        self._last_poll = now
        try:
            events = self._diff()
            if self._error_logged and events:
                self._error_logged = False
            return events
        except sqlite3.Error as exc:
            if not self._error_logged:
                _log.warning(
                    "sqlite poll failed for %s.%s: %s (stream idles until the "
                    "table is reachable again)", self.path, self.table_name, exc,
                )
                self._error_logged = True
            return []


def read(
    path: str,
    table_name: str,
    schema: SchemaMetaclass,
    *,
    mode: str = "streaming",
    poll_interval_s: float | None = None,
    autocommit_duration_ms: int = 500,
    **kwargs,
) -> Table:
    if poll_interval_s is None:
        poll_interval_s = autocommit_duration_ms / 1000.0
    source = SqliteSnapshotSource(
        path, table_name, schema, poll_interval_s=poll_interval_s, mode=mode
    )
    return make_input_table(schema, source, name=f"sqlite:{table_name}", persistent_id=kwargs.get("persistent_id"))


class SqliteWriter:
    """Maintains an output table mirroring the stream (insert/delete)."""

    TIME_COL = "__pw_time"
    DIFF_COL = "__pw_diff"

    def __init__(self, path: str, table_name: str, colnames: list[str]):
        if self.TIME_COL in colnames or self.DIFF_COL in colnames:
            raise ValueError(
                f"output columns may not be named {self.TIME_COL}/{self.DIFF_COL}"
            )
        self.path = path
        self.table_name = table_name
        self.colnames = colnames
        con = sqlite3.connect(path)
        cols_ddl = ", ".join(_q(c) for c in colnames)
        con.execute(
            f"CREATE TABLE IF NOT EXISTS {_q(table_name)} "
            f"({cols_ddl}, {_q(self.TIME_COL)} INTEGER, {_q(self.DIFF_COL)} INTEGER)"
        )
        con.commit()
        con.close()
        self._insert_sql = (
            f"INSERT INTO {_q(table_name)} "
            f"({', '.join(_q(c) for c in colnames)}, "
            f"{_q(self.TIME_COL)}, {_q(self.DIFF_COL)}) "
            f"VALUES ({', '.join('?' for _ in colnames)}, ?, ?)"
        )

    def write_batch(self, time_: int, colnames: list[str], updates: list) -> None:
        con = sqlite3.connect(self.path)
        try:
            for _key, row, diff in updates:
                vals = [_sql_value(v) for v in unwrap_row(row)]
                con.execute(self._insert_sql, vals + [time_, diff])
            con.commit()
        finally:
            con.close()

    def close(self) -> None:
        pass


def _sql_value(v):
    if isinstance(v, (int, float, str, bytes, type(None))):
        return v
    return str(v)


def write(table: Table, path: str, table_name: str, **kwargs) -> None:
    writer = SqliteWriter(path, table_name, table.column_names())
    pg.new_output_node(
        "output", [table], colnames=table.column_names(), writer=writer
    )
