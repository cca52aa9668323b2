"""MySQL connector (reference: src/connectors/data_storage/mysql.rs, 2,023
LoC).  Input is CDC by snapshot-diff polling (the reference's non-binlog
path): the table is re-read each poll interval and compared with the prior
snapshot, emitting Z-set deltas keyed on the primary key.  Output mirrors
postgres: a stream-of-changes appender or a live snapshot maintained with
`INSERT ... ON DUPLICATE KEY UPDATE` / `DELETE` (MySQL dialect).

The DB-API connection comes from one seam (`_connect`) — pymysql/mysqlclient
when installed, injectable fakes in tests (same standard as io/postgres.py).

The port of ``pathway_tpu/io/mysql.py``.  A failed poll is logged once
and retried at the next poll, and counted in ``n_failed_polls``; the
commit that ends a read (so that the next poll sees fresh commits) and a
writer's ``close`` raise when they fail, where the JAX module swallows
both.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Iterable

from ..engine.types import unwrap_row
from ..internals import parse_graph as pg
from ..internals.datasource import DataSource
from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from ..internals.value import ref_scalar
from ._utils import coerce_value, make_input_table
from ..internals.config import _check_entitlements

_log = logging.getLogger("pathway_tpu_torch.io.mysql")


def _connect(settings: dict):
    injected = settings.get("_connection")
    if injected is not None:
        return injected
    clean = {k: v for k, v in settings.items() if not k.startswith("_")}
    try:
        import pymysql

        return pymysql.connect(**clean)
    except ImportError:
        pass
    try:
        import MySQLdb

        return MySQLdb.connect(**clean)
    except ImportError as exc:
        raise ImportError(
            "pw.io.mysql requires pymysql or mysqlclient (or an injected "
            "_connection for tests)"
        ) from exc


def _q(ident: str) -> str:
    return "`" + ident.replace("`", "``") + "`"


class MysqlSnapshotSource(DataSource):
    """Poll-and-diff CDC over one table."""

    def __init__(self, settings: dict, table_name: str,
                 schema: SchemaMetaclass, poll_interval_s: float,
                 mode: str):
        self.settings = settings
        self.table_name = table_name
        self.schema = schema
        self.poll_interval_s = poll_interval_s
        self.mode = mode
        self._snapshot: dict[Any, tuple] = {}
        self._conn = None
        self._last_poll = 0.0
        self._first = True
        self._error_logged = False
        self.n_failed_polls = 0

    def is_live(self) -> bool:
        return self.mode == "streaming"

    def _cursor(self):
        if self._conn is None:
            self._conn = _connect(self.settings)
        return self._conn.cursor()

    def _read_rows(self) -> dict[Any, tuple]:
        colnames = self.schema.column_names()
        dtypes = self.schema.dtypes()
        pk = self.schema.primary_key_columns()
        cur = self._cursor()
        cur.execute(
            f"SELECT {', '.join(_q(c) for c in colnames)} "
            f"FROM {_q(self.table_name)}"
        )
        out: dict[Any, tuple] = {}
        occurrence: dict[tuple, int] = {}
        for i, raw in enumerate(cur.fetchall()):
            d = dict(zip(colnames, raw))
            row = tuple(coerce_value(d[c], dtypes[c]) for c in colnames)
            if pk:
                key = ref_scalar(*[d[c] for c in pk])
            else:
                # no declared pk: key on content + occurrence index so
                # duplicate rows keep their multiplicity (removing one of
                # two identical rows retracts exactly one)
                occ = occurrence.get(raw, 0)
                occurrence[raw] = occ + 1
                key = ref_scalar("#mysqlrow", *raw, occ)
            out[key] = row
        # polling connections must observe fresh commits (pymysql and
        # mysqlclient commit without error in autocommit mode too)
        self._conn.commit()
        return out

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
            self._error_logged = False
            return events
        except Exception as exc:
            self.n_failed_polls += 1
            if not self._error_logged:
                _log.warning(
                    "mysql poll failed for %s: %s (stream idles until the "
                    "table is reachable again)", self.table_name, exc,
                )
                self._error_logged = True
            # a dead connection is retried fresh on the next poll
            self._conn = None
            return []


def read(
    mysql_settings: dict,
    table_name: str,
    schema: SchemaMetaclass,
    *,
    mode: str = "streaming",
    poll_interval_s: float | None = None,
    autocommit_duration_ms: int = 500,
    **kwargs,
) -> Table:
    _check_entitlements("mysql")
    if poll_interval_s is None:
        poll_interval_s = autocommit_duration_ms / 1000.0
    source = MysqlSnapshotSource(
        mysql_settings, table_name, schema,
        poll_interval_s=poll_interval_s, mode=mode,
    )
    return make_input_table(schema, source, name=f"mysql:{table_name}", persistent_id=kwargs.get("persistent_id"))


class _MysqlWriter:
    def __init__(self, settings: dict, table_name: str, *,
                 snapshot: bool = False, primary_key: list[str] | None = None,
                 init_mode: str = "default"):
        self.settings = settings
        self.table_name = table_name
        self.snapshot = snapshot
        self.primary_key = primary_key or []
        self.init_mode = init_mode
        self._conn = None
        self._initialized = False

    def _ensure(self, colnames: list[str]):
        if self._conn is None:
            self._conn = _connect(self.settings)
        if not self._initialized:
            self._initialized = True
            if self.init_mode in ("create_if_not_exists", "replace"):
                cur = self._conn.cursor()
                if self.init_mode == "replace":
                    cur.execute(
                        f"DROP TABLE IF EXISTS {_q(self.table_name)}"
                    )
                cols = ", ".join(f"{_q(c)} TEXT" for c in colnames)
                pk = ""
                if self.snapshot and self.primary_key:
                    # TEXT pk columns need a keyable type in MySQL
                    cols = ", ".join(
                        f"{_q(c)} VARCHAR(255)" if c in self.primary_key
                        else f"{_q(c)} TEXT"
                        for c in colnames
                    )
                    pk = (
                        ", PRIMARY KEY ("
                        + ", ".join(_q(c) for c in self.primary_key) + ")"
                    )
                extra = "" if self.snapshot else ", `time` BIGINT, `diff` BIGINT"
                cur.execute(
                    f"CREATE TABLE IF NOT EXISTS {_q(self.table_name)} "
                    f"({cols}{extra}{pk})"
                )
                self._conn.commit()
        return self._conn

    def write_batch(self, time_, colnames, updates) -> None:
        if not updates:
            return
        conn = self._ensure(list(colnames))
        cur = conn.cursor()
        tbl = _q(self.table_name)
        qcols = [_q(c) for c in colnames]
        if not self.snapshot:
            sql = (
                f"INSERT INTO {tbl} ({', '.join(qcols)}, `time`, `diff`) "
                f"VALUES ({', '.join(['%s'] * (len(qcols) + 2))})"
            )
            for _key, row, diff in updates:
                cur.execute(sql, tuple(unwrap_row(row)) + (time_, diff))
        else:
            pk = self.primary_key or [list(colnames)[0]]
            pk_q = [_q(c) for c in pk]
            non_pk = [c for c in colnames if c not in pk]
            set_clause = ", ".join(
                f"{_q(c)} = VALUES({_q(c)})" for c in non_pk
            ) or f"{pk_q[0]} = VALUES({pk_q[0]})"
            upsert = (
                f"INSERT INTO {tbl} ({', '.join(qcols)}) "
                f"VALUES ({', '.join(['%s'] * len(qcols))}) "
                f"ON DUPLICATE KEY UPDATE {set_clause}"
            )
            pk_idx = [list(colnames).index(c) for c in pk]
            delete = (
                f"DELETE FROM {tbl} WHERE "
                + " AND ".join(f"{q} = %s" for q in pk_q)
            )
            for _key, row, diff in updates:
                vals = tuple(unwrap_row(row))
                if diff > 0:
                    cur.execute(upsert, vals)
                else:
                    cur.execute(delete, tuple(vals[i] for i in pk_idx))
        conn.commit()

    def close(self) -> None:
        # a failed close raises (the JAX writer swallows it)
        if self._conn is not None:
            self._conn.close()


def write(
    table: Table,
    mysql_settings: dict,
    table_name: str,
    *,
    init_mode: str = "default",
    output_table_type: str = "stream_of_changes",
    primary_key: Iterable[Any] | None = None,
    **kwargs,
) -> None:
    """Reference: mysql.rs MysqlWriter."""
    pk_names = [getattr(c, "_name", c) for c in (primary_key or [])]
    pg.new_output_node(
        "output", [table], colnames=table.column_names(),
        writer=_MysqlWriter(
            mysql_settings, table_name,
            snapshot=(output_table_type == "snapshot"),
            primary_key=pk_names, init_mode=init_mode,
        ),
    )


def write_snapshot(
    table: Table,
    mysql_settings: dict,
    table_name: str,
    primary_key: Iterable[Any],
    *,
    init_mode: str = "default",
    **kwargs,
) -> None:
    write(
        table, mysql_settings, table_name, init_mode=init_mode,
        output_table_type="snapshot", primary_key=primary_key,
    )
