"""DuckDB output connector (reference: python/pathway/io/duckdb/__init__.py:42
over src/connectors/data_storage/duckdb.rs, 1,361 LoC).

DuckDB is in-process, so the connector writes straight into the database
file.  Two output table types: "stream_of_changes" appends every change
with time/diff columns; "snapshot" maintains the live state with
`INSERT ... ON CONFLICT DO UPDATE` / `DELETE` keyed on `primary_key`
(required in that mode, forbidden otherwise — reference contract, including
the NULL-key rejection: a NULL primary key would make the retraction DELETE
never match).  `init_mode` = default / create_if_not_exists / replace.

The connection is one seam (`_connect`): the `duckdb` package when
installed, else an injected DB-API `_connection` (tests use sqlite3, which
shares the `?`-placeholder dialect and ON CONFLICT syntax).

The port of ``pathway_tpu/io/duckdb.py``.  A failed ``close`` of a
connection this writer opened raises, where the JAX writer swallows it;
injected connections are left open, as there.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Iterable, Literal

from ..engine.types import unwrap_row
from ..internals import dtype as dt
from ..internals.expression import ColumnReference
from ..internals.table import Table
from ._utils import add_output_node, plain_scalar
from ..internals.config import _check_entitlements


def _connect(database, injected=None):
    if injected is not None:
        return injected
    try:
        import duckdb  # type: ignore

        return duckdb.connect(str(database))
    except ImportError as exc:
        raise ImportError(
            "pw.io.duckdb requires the duckdb package (or an injected "
            "_connection for tests)"
        ) from exc


def _q(ident: str) -> str:
    return '"' + ident.replace('"', '""') + '"'


def _sql_type(d: dt.DType) -> str:
    d = d.strip_optional()
    return {
        dt.INT: "BIGINT", dt.FLOAT: "DOUBLE", dt.STR: "VARCHAR",
        dt.BOOL: "BOOLEAN", dt.BYTES: "BLOB",
    }.get(d, "VARCHAR")


class _DuckDBWriter:
    def __init__(self, database, table_name: str, *, snapshot: bool,
                 primary_key: list[str], init_mode: str,
                 max_batch_size: int | None, detach_between_batches: bool,
                 dtypes: dict, _connection=None):
        self.database = database
        self.table_name = table_name
        self.snapshot = snapshot
        self.primary_key = primary_key
        self.init_mode = init_mode
        self.max_batch_size = max_batch_size
        self.detach_between_batches = detach_between_batches
        self.dtypes = dtypes
        self._injected = _connection
        self._conn = None
        self._initialized = False

    def _connection(self):
        if self._conn is None:
            self._conn = _connect(self.database, self._injected)
        return self._conn

    def _ensure(self, colnames: list[str]):
        conn = self._connection()
        if self._initialized:
            return conn
        self._initialized = True
        tbl = _q(self.table_name)
        cur = conn.cursor()
        if self.init_mode == "replace":
            cur.execute(f"DROP TABLE IF EXISTS {tbl}")
        if self.init_mode in ("create_if_not_exists", "replace"):
            cols = [f"{_q(c)} {_sql_type(self.dtypes.get(c, dt.ANY))}"
                    for c in colnames]
            if self.snapshot:
                cols.append(
                    f"PRIMARY KEY ({', '.join(_q(c) for c in self.primary_key)})"
                )
            else:
                cols.append("time BIGINT")
                cols.append("diff SMALLINT")
            cur.execute(
                f"CREATE TABLE IF NOT EXISTS {tbl} ({', '.join(cols)})"
            )
            conn.commit()
        else:
            # default mode: the destination must already exist and carry
            # every needed column; fail with a clear error up front
            try:
                cur.execute(f"SELECT * FROM {tbl} LIMIT 0")
            except Exception as exc:
                raise ValueError(
                    f"pw.io.duckdb.write: destination table "
                    f"{self.table_name!r} does not exist (init_mode="
                    '"default" requires it; use "create_if_not_exists")'
                ) from exc
            existing = {d[0] for d in cur.description or []}
            needed = set(colnames) | (
                set() if self.snapshot else {"time", "diff"}
            )
            missing = sorted(needed - existing)
            if missing:
                raise ValueError(
                    f"pw.io.duckdb.write: destination table "
                    f"{self.table_name!r} lacks columns {missing}"
                )
        return conn

    def write_batch(self, time_, colnames, updates) -> None:
        if not updates:
            return
        colnames = list(colnames)
        conn = self._ensure(colnames)
        cur = conn.cursor()
        tbl = _q(self.table_name)
        qcols = [_q(c) for c in colnames]
        rows = [(key, tuple(plain_scalar(v, keep_bytes=True)
                            for v in unwrap_row(row)), diff)
                for key, row, diff in updates]

        def chunked(seq):
            if not self.max_batch_size:
                return [seq]
            return [seq[i:i + self.max_batch_size]
                    for i in range(0, len(seq), self.max_batch_size)]

        if not self.snapshot:
            sql = (
                f"INSERT INTO {tbl} ({', '.join(qcols)}, time, diff) "
                f"VALUES ({', '.join(['?'] * (len(qcols) + 2))})"
            )
            for chunk in chunked(rows):
                cur.executemany(
                    sql, [vals + (time_, diff) for _k, vals, diff in chunk]
                )
                conn.commit()
        else:
            pk_q = [_q(c) for c in self.primary_key]
            pk_idx = [colnames.index(c) for c in self.primary_key]
            non_pk = [c for c in colnames if c not in self.primary_key]
            set_clause = ", ".join(
                f"{_q(c)} = EXCLUDED.{_q(c)}" for c in non_pk
            ) or f"{pk_q[0]} = {pk_q[0]}"
            upsert = (
                f"INSERT INTO {tbl} ({', '.join(qcols)}) "
                f"VALUES ({', '.join(['?'] * len(qcols))}) "
                f"ON CONFLICT ({', '.join(pk_q)}) DO UPDATE "
                f"SET {set_clause}"
            )
            delete = (
                f"DELETE FROM {tbl} WHERE "
                + " AND ".join(f"{q} = ?" for q in pk_q)
            )
            # ALL deletes before ANY upsert (an update pair split across
            # size chunks must never end with its key deleted), then ONE
            # commit: readers never observe the between-passes state and a
            # crash can't drop updated rows (max_batch_size bounds
            # statement batching, not transaction scope)
            deletes = [r for r in rows if r[2] < 0]
            upserts = [r for r in rows if r[2] > 0]
            for chunk in chunked(deletes):
                for _k, vals, _d in chunk:
                    cur.execute(delete, tuple(vals[i] for i in pk_idx))
            for chunk in chunked(upserts):
                for _k, vals, _d in chunk:
                    cur.execute(upsert, vals)
            conn.commit()
        if self.detach_between_batches and self._injected is None:
            self._conn = None
            conn.close()

    def close(self) -> None:
        # injected connections belong to the caller (tests query them after
        # the run); only connections this writer opened are closed
        conn, self._conn = self._conn, None
        if conn is not None and self._injected is None:
            conn.close()


def write(table: Table, *, table_name: str, database,
          max_batch_size: int | None = None,
          init_mode: Literal["default", "create_if_not_exists",
                             "replace"] = "default",
          output_table_type: Literal["stream_of_changes",
                                     "snapshot"] = "stream_of_changes",
          primary_key: list[ColumnReference] | None = None,
          detach_between_batches: bool = False,
          name: str | None = None,
          sort_by: Iterable[ColumnReference] | None = None,
          _connection=None) -> None:
    """Write `table` into a table of a DuckDB database file."""
    _check_entitlements("duckdb")
    colnames = table.column_names()
    dtypes = table.schema.dtypes()
    snapshot = output_table_type == "snapshot"
    if output_table_type not in ("stream_of_changes", "snapshot"):
        raise ValueError(f"unknown output_table_type {output_table_type!r}")
    if snapshot:
        if not primary_key:
            raise ValueError(
                'pw.io.duckdb.write: output_table_type="snapshot" requires '
                "primary_key"
            )
        pk = []
        for ref in primary_key:
            cname = ref._name if isinstance(ref, ColumnReference) else str(ref)
            if cname not in colnames:
                raise ValueError(
                    f"primary_key column {cname!r} does not belong to the "
                    "written table"
                )
            if isinstance(dtypes.get(cname), dt.Optional):
                raise ValueError(
                    f"primary_key column {cname!r} is Optional: a NULL key "
                    "would make retraction DELETEs never match"
                )
            pk.append(cname)
    else:
        if primary_key:
            raise ValueError(
                "pw.io.duckdb.write: primary_key is only valid with "
                'output_table_type="snapshot"'
            )
        pk = []
        if "time" in colnames or "diff" in colnames:
            raise ValueError(
                "pw.io.duckdb.write: columns named time/diff collide with "
                "the stream-of-changes metadata columns"
            )
    add_output_node(table, _DuckDBWriter(
        database, table_name, snapshot=snapshot, primary_key=pk,
        init_mode=init_mode, max_batch_size=max_batch_size,
        detach_between_batches=detach_between_batches, dtypes=dtypes,
        _connection=_connection,
    ))
