"""Microsoft SQL Server connector (reference: python/pathway/io/mssql/
__init__.py:38,276 over src/connectors/data_storage/mssql.rs, 2,926 LoC).

Input: "static" mode issues one SELECT and terminates; "streaming" mode
uses MSSQL's Change Data Capture — an initial snapshot, then polling
`cdc.fn_cdc_get_all_changes_<capture_instance>` with Log Sequence Number
(LSN) offsets (operation codes: 1=delete, 2=insert, 3=update-before,
4=update-after).  If CDC is not enabled on the table, streaming mode fails
at startup with an error pointing at `sp_cdc_enable_table` — it does not
silently fall back to re-reading the table (reference contract).  The
schema must declare primary-key columns.

Output mirrors postgres with the T-SQL dialect: bracket-quoted
identifiers, stream-of-changes appender or MERGE-based snapshot upserts.

The DB-API connection comes from one seam (`_connect`) — pyodbc/pymssql
when installed, injectable fakes in tests.

The port of ``pathway_tpu/io/mssql.py``.  A failed poll is logged once
and retried at the next poll, and counted in ``n_failed_polls``; a
writer's failed ``close`` raises.
"""

from __future__ import annotations

import logging
import re
import time
from typing import Any, Iterable, Literal

from ..engine.types import unwrap_row
from ..internals import parse_graph as pg
from ..internals.datasource import DataSource
from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from ..internals.value import ref_scalar
from ._utils import coerce_value, make_input_table
from ..internals.config import _check_entitlements

_log = logging.getLogger("pathway_tpu_torch.io.mssql")


def _connect(settings):
    if isinstance(settings, dict):
        injected = settings.get("_connection")
        if injected is not None:
            return injected
        conn_str = settings.get("connection_string", "")
    else:
        conn_str = settings
    try:
        import pyodbc  # type: ignore

        return pyodbc.connect(conn_str)
    except ImportError as exc:
        # only pyodbc: this module speaks qmark paramstyle throughout,
        # which pymssql (pyformat) cannot execute
        raise ImportError(
            "pw.io.mssql requires pyodbc (or an injected _connection "
            "for tests)"
        ) from exc


def _validate_identifier(arg: str, value: str) -> None:
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_$#@ ]*", value or ""):
        raise ValueError(f"invalid SQL Server identifier for {arg}: {value!r}")


def _q(ident: str) -> str:
    return "[" + ident.replace("]", "]]") + "]"


class MssqlCdcSource(DataSource):
    """Initial snapshot + LSN-offset CDC polling over one table."""

    def __init__(self, settings, table_name: str, schema: SchemaMetaclass,
                 *, schema_name: str, mode: str, poll_interval_s: float):
        self.settings = settings
        self.table_name = table_name
        self.schema = schema
        self.schema_name = schema_name
        self.mode = mode
        self.poll_interval_s = poll_interval_s
        self.capture_instance = f"{schema_name}_{table_name}"
        # schema-derived structures hoisted off the per-row hot path
        self._colnames = schema.column_names()
        self._dtypes = schema.dtypes()
        self._pk_idx = [self._colnames.index(c)
                        for c in schema.primary_key_columns()]
        self._conn = None
        self._lsn = None  # bytes: last processed LSN
        self._snapshot_done = False
        self._last_poll = 0.0
        self._error_logged = False
        self.n_failed_polls = 0
        # pk-keyed upsert state: CDC events reconcile against it, so a
        # change that lands in both the snapshot and the first delta poll
        # (the classic snapshot/CDC race) applies exactly once
        self._state: dict[Any, tuple] = {}

    def is_live(self) -> bool:
        return self.mode == "streaming"

    # -- persistence offsets (LSN) --------------------------------------
    def get_offsets(self):
        return {"lsn": self._lsn.hex() if self._lsn else None,
                "snapshot_done": self._snapshot_done}

    def seek(self, offset) -> None:
        if not offset:
            return
        lsn = offset.get("lsn")
        self._lsn = bytes.fromhex(lsn) if lsn else None
        self._snapshot_done = bool(offset.get("snapshot_done"))

    # -------------------------------------------------------------------
    def _cursor(self):
        if self._conn is None:
            self._conn = _connect(self.settings)
        return self._conn.cursor()

    def _key_row(self, raw: tuple):
        row = tuple(
            coerce_value(v, self._dtypes[c])
            for v, c in zip(raw, self._colnames)
        )
        key = ref_scalar(*[raw[i] for i in self._pk_idx])
        return key, row

    def _apply_upsert(self, key, row) -> list:
        old = self._state.get(key)
        if old == row:
            return []
        events = []
        if old is not None:
            events.append((0, key, old, -1))
        self._state[key] = row
        events.append((0, key, row, 1))
        return events

    def _apply_delete(self, key) -> list:
        old = self._state.pop(key, None)
        return [] if old is None else [(0, key, old, -1)]

    def _select_all(self) -> list:
        colnames = self.schema.column_names()
        cur = self._cursor()
        cur.execute(
            f"SELECT {', '.join(_q(c) for c in colnames)} "
            f"FROM {_q(self.schema_name)}.{_q(self.table_name)}"
        )
        events = []
        for raw in cur.fetchall():
            key, row = self._key_row(raw)
            events.extend(self._apply_upsert(key, row))
        return events

    def _check_cdc(self) -> None:
        cur = self._cursor()
        try:
            cur.execute(
                "SELECT capture_instance FROM cdc.change_tables ct "
                "JOIN sys.tables t ON ct.source_object_id = t.object_id "
                "WHERE t.name = ?", (self.table_name,),
            )
            rows = cur.fetchall()
        except Exception as exc:
            raise RuntimeError(
                f"pw.io.mssql: CDC is not enabled on the database "
                f"(streaming mode requires it): {exc}. Run "
                "EXEC sys.sp_cdc_enable_db and EXEC sys.sp_cdc_enable_table "
                f"@source_schema=N'{self.schema_name}', "
                f"@source_name=N'{self.table_name}', @role_name=NULL"
            ) from exc
        if not rows:
            # CDC on the database but not on this table: fail at startup
            # with the pointer, never silently idle (module contract)
            raise RuntimeError(
                f"pw.io.mssql: CDC is not enabled on table "
                f"{self.schema_name}.{self.table_name} (streaming mode "
                "requires it). Run EXEC sys.sp_cdc_enable_table "
                f"@source_schema=N'{self.schema_name}', "
                f"@source_name=N'{self.table_name}', @role_name=NULL"
            )
        self.capture_instance = rows[0][0]

    def _max_lsn(self) -> bytes | None:
        cur = self._cursor()
        cur.execute("SELECT sys.fn_cdc_get_max_lsn()")
        row = cur.fetchone()
        return bytes(row[0]) if row and row[0] is not None else None

    def _poll_changes(self) -> list:
        to_lsn = self._max_lsn()
        if to_lsn is None or (self._lsn is not None and to_lsn <= self._lsn):
            return []
        cur = self._cursor()
        colnames = self.schema.column_names()
        if self._lsn is None:
            cur.execute(
                f"SELECT sys.fn_cdc_get_min_lsn('{self.capture_instance}')"
            )
            row = cur.fetchone()
            from_lsn = bytes(row[0]) if row and row[0] is not None else b"\0"
        else:
            # changes strictly after the processed LSN
            cur.execute("SELECT sys.fn_cdc_increment_lsn(?)", (self._lsn,))
            from_lsn = bytes(cur.fetchone()[0])
        cur.execute(
            "SELECT __$operation, "
            + ", ".join(_q(c) for c in colnames)
            + f" FROM cdc.fn_cdc_get_all_changes_{self.capture_instance}"
            "(?, ?, N'all update old') "
            "ORDER BY __$start_lsn, __$seqval, __$operation",
            (from_lsn, to_lsn),
        )
        events = []
        for raw in cur.fetchall():
            op, vals = raw[0], tuple(raw[1:])
            key, row = self._key_row(vals)
            if op in (2, 4):        # insert / update-after
                events.extend(self._apply_upsert(key, row))
            elif op == 3:
                # update-before: retract the OLD key here (covers updates
                # that change a primary-key column — the op-4 after-image
                # arrives under the new key and cannot retract the old
                # one); after an LSN seek the state is cold and the CDC
                # before-image itself is the retraction
                if key in self._state:
                    events.extend(self._apply_delete(key))
                else:
                    events.append((0, key, row, -1))
            elif op == 1:           # delete
                if key in self._state:
                    events.extend(self._apply_delete(key))
                else:               # post-seek: trust the CDC before-image
                    events.append((0, key, row, -1))
        self._lsn = to_lsn
        return events

    def static_events(self) -> list:
        if self.mode == "streaming":
            return []
        return self._select_all()

    def poll(self):
        now = time.monotonic()
        if self._snapshot_done and now - self._last_poll < self.poll_interval_s:
            return []
        self._last_poll = now
        try:
            if not self._snapshot_done:
                self._check_cdc()
                # fix the CDC horizon BEFORE the snapshot so changes that
                # race the snapshot replay as deltas, not duplicates
                self._lsn = self._max_lsn()
                events = self._select_all()
                self._snapshot_done = True
                self._error_logged = False
                return events
            events = self._poll_changes()
            self._error_logged = False
            return events
        except RuntimeError:
            raise  # CDC-missing is a startup error, not a retry
        except Exception as exc:
            self.n_failed_polls += 1
            if not self._error_logged:
                _log.warning(
                    "mssql poll failed for %s: %s (stream idles until the "
                    "server is reachable again)", self.table_name, exc,
                )
                self._error_logged = True
            self._conn = None
            return []


def read(connection_string, table_name: str, schema: SchemaMetaclass, *,
         mode: Literal["static", "streaming"] = "streaming",
         schema_name: str = "dbo",
         autocommit_duration_ms: int | None = 1500,
         name: str | None = None, max_backlog_size: int | None = None,
         debug_data: Any = None, **kwargs) -> Table:
    """Read a SQL Server table (static SELECT or CDC streaming)."""
    _check_entitlements("mssql")
    _validate_identifier("table_name", table_name)
    _validate_identifier("schema_name", schema_name)
    if mode == "streaming" and not schema.primary_key_columns():
        raise ValueError(
            "pw.io.mssql.read in streaming mode requires primary-key "
            "columns in the schema (pw.column_definition(primary_key=True))"
        )
    source = MssqlCdcSource(
        connection_string, table_name, schema, schema_name=schema_name,
        mode=mode,
        poll_interval_s=(autocommit_duration_ms or 1500) / 1000.0,
    )
    return make_input_table(schema, source, name=f"mssql:{table_name}", persistent_id=kwargs.get("persistent_id"))


class _MssqlWriter:
    def __init__(self, settings, table_name: str, *, snapshot: bool,
                 primary_key: list[str], init_mode: str,
                 key_type: str = "NVARCHAR(450)"):
        self.settings = settings
        self.table_name = table_name
        self.snapshot = snapshot
        self.primary_key = primary_key
        self.init_mode = init_mode
        self.key_type = key_type
        self._conn = None
        self._initialized = False

    def _ensure(self, colnames):
        if self._conn is None:
            self._conn = _connect(self.settings)
        if not self._initialized:
            self._initialized = True
            if self.init_mode in ("create_if_not_exists", "replace"):
                cur = self._conn.cursor()
                tbl = _q(self.table_name)
                if self.init_mode == "replace":
                    cur.execute(
                        f"IF OBJECT_ID(N'{self.table_name}', N'U') IS NOT "
                        f"NULL DROP TABLE {tbl}"
                    )
                pk = (self.primary_key or [colnames[0]]) if self.snapshot \
                    else []
                # snapshot upsert correctness depends on key uniqueness, so
                # key columns get an indexable type + PRIMARY KEY (the
                # rowcount-based upsert must not be the only guard against
                # duplicate rows); NVARCHAR(MAX) cannot be indexed
                cols = ", ".join(
                    f"{_q(c)} {self.key_type} NOT NULL" if c in pk
                    else f"{_q(c)} NVARCHAR(MAX)" for c in colnames
                )
                extra = "" if self.snapshot else \
                    ", [time] BIGINT, [diff] SMALLINT"
                if pk:
                    extra += (
                        ", PRIMARY KEY ("
                        + ", ".join(_q(c) for c in pk) + ")"
                    )
                cur.execute(
                    f"IF OBJECT_ID(N'{self.table_name}', N'U') IS NULL "
                    f"CREATE TABLE {tbl} ({cols}{extra})"
                )
                self._conn.commit()
        return self._conn

    def write_batch(self, time_, colnames, updates) -> None:
        if not updates:
            return
        colnames = list(colnames)
        conn = self._ensure(colnames)
        cur = conn.cursor()
        tbl = _q(self.table_name)
        qcols = [_q(c) for c in colnames]
        if not self.snapshot:
            sql = (
                f"INSERT INTO {tbl} ({', '.join(qcols)}, [time], [diff]) "
                f"VALUES ({', '.join(['?'] * (len(qcols) + 2))})"
            )
            for _key, row, diff in updates:
                cur.execute(sql, tuple(unwrap_row(row)) + (time_, diff))
        else:
            pk = self.primary_key or [colnames[0]]
            pk_idx = [colnames.index(c) for c in pk]
            delete = (
                f"DELETE FROM {tbl} WHERE "
                + " AND ".join(f"{_q(c)} = ?" for c in pk)
            )
            # T-SQL upsert: UPDATE, then INSERT when no row matched
            setters = ", ".join(
                f"{_q(c)} = ?" for c in colnames if c not in pk
            )
            update = (
                f"UPDATE {tbl} SET {setters} WHERE "
                + " AND ".join(f"{_q(c)} = ?" for c in pk)
            ) if setters else None
            insert = (
                f"INSERT INTO {tbl} ({', '.join(qcols)}) "
                f"VALUES ({', '.join(['?'] * len(qcols))})"
            )
            for _key, row, diff in updates:
                vals = tuple(unwrap_row(row))
                pkv = tuple(vals[i] for i in pk_idx)
                if diff < 0:
                    cur.execute(delete, pkv)
            for _key, row, diff in updates:
                vals = tuple(unwrap_row(row))
                pkv = tuple(vals[i] for i in pk_idx)
                if diff > 0:
                    matched = 0
                    if update is not None:
                        non_pk = tuple(
                            vals[i] for i, c in enumerate(colnames)
                            if c not in pk
                        )
                        cur.execute(update, non_pk + pkv)
                        matched = cur.rowcount
                    if matched == -1:
                        # DB-API allows rowcount == -1 (NOCOUNT / some ODBC
                        # drivers): fall back to an existence probe instead
                        # of mis-reading "no match" and double-inserting
                        cur.execute(
                            f"SELECT 1 FROM {tbl} WHERE "
                            + " AND ".join(f"{_q(c)} = ?" for c in pk),
                            pkv,
                        )
                        matched = 1 if cur.fetchone() else 0
                    if matched <= 0:
                        cur.execute(insert, vals)
        conn.commit()

    def close(self) -> None:
        # a failed close raises (the JAX writer swallows it)
        if self._conn is not None:
            self._conn.close()


def write(table: Table, connection_string, table_name: str, *,
          init_mode: str = "default", name: str | None = None,
          sort_by=None, **kwargs) -> None:
    """Append the table's stream of changes (time/diff columns)."""
    _validate_identifier("table_name", table_name)
    pg.new_output_node(
        "output", [table], colnames=table.column_names(),
        writer=_MssqlWriter(connection_string, table_name, snapshot=False,
                            primary_key=[], init_mode=init_mode),
    )


def write_snapshot(table: Table, connection_string, table_name: str,
                   primary_key: list[str], *, init_mode: str = "default",
                   key_type: str = "NVARCHAR(450)",
                   name: str | None = None, **kwargs) -> None:
    """Maintain the live snapshot keyed on `primary_key`.

    When this writer creates the table, key columns are declared
    `key_type NOT NULL` with a PRIMARY KEY so the upsert cannot silently
    accumulate duplicate rows.  The NVARCHAR(450) default is the widest
    single-column string type SQL Server can index (900-byte key limit);
    pass a narrower/different `key_type` for longer composite keys, or
    pre-create the table yourself (init_mode="default") to keep full
    control of the DDL."""
    _validate_identifier("table_name", table_name)
    pg.new_output_node(
        "output", [table], colnames=table.column_names(),
        writer=_MssqlWriter(connection_string, table_name, snapshot=True,
                            primary_key=list(primary_key),
                            init_mode=init_mode, key_type=key_type),
    )
