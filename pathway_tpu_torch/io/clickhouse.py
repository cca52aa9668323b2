"""ClickHouse connector over the native HTTP interface (reference:
src/connectors/data_storage/clickhouse.rs, 947 LoC).

No client library: ClickHouse speaks HTTP — queries POST to `/` and rows
stream as JSONEachRow.  `write` appends a stream of changes (time/diff
columns); `write_snapshot` maintains the live snapshot with
`INSERT` / `ALTER TABLE ... DELETE` keyed on the primary key.  `read` is
snapshot-diff polling CDC like io/mysql.py.

The HTTP seam (`_http`) is injectable for tests (a local fake server
thread speaks enough of the protocol).

The port of ``pathway_tpu/io/clickhouse.py``.  A failed poll is logged
once and retried at the next poll, and counted in ``n_failed_polls``.
"""

from __future__ import annotations

import json
import logging
import time
import urllib.parse
import urllib.request
from typing import Any, Iterable

from ..engine.types import unwrap_row
from ..internals import parse_graph as pg
from ..internals.datasource import DataSource
from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from ..internals.value import ref_scalar
from ._utils import coerce_value, make_input_table, plain_scalar
from ..internals.config import _check_entitlements

_log = logging.getLogger("pathway_tpu_torch.io.clickhouse")


class ClickHouseSettings:
    def __init__(self, *, host: str = "localhost", port: int = 8123,
                 user: str = "default", password: str = "",
                 database: str = "default", secure: bool = False,
                 _http=None):
        self.host = host
        self.port = port
        self.user = user
        self.password = password
        self.database = database
        self.secure = secure
        self._http = _http  # injectable: fn(query, body=None) -> bytes

    def http(self, query: str, body: bytes | None = None) -> bytes:
        if self._http is not None:
            return self._http(query, body)
        scheme = "https" if self.secure else "http"
        params = urllib.parse.urlencode({
            "query": query, "database": self.database,
            "user": self.user, "password": self.password,
        })
        req = urllib.request.Request(
            f"{scheme}://{self.host}:{self.port}/?{params}",
            data=body if body is not None else b"",
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.read()


def _q(ident: str) -> str:
    return "`" + ident.replace("`", "``") + "`"


def _ch_type(v: Any) -> str:
    if isinstance(v, bool):
        return "UInt8"
    if isinstance(v, int):
        return "Int64"
    if isinstance(v, float):
        return "Float64"
    return "String"


class ClickHouseSource(DataSource):
    """Snapshot-diff polling CDC over one table (JSONEachRow transport)."""

    def __init__(self, settings: ClickHouseSettings, table_name: str,
                 schema: SchemaMetaclass, poll_interval_s: float, mode: str):
        self.settings = settings
        self.table_name = table_name
        self.schema = schema
        self.poll_interval_s = poll_interval_s
        self.mode = mode
        self._snapshot: dict[Any, tuple] = {}
        self._last_poll = 0.0
        self._first = True
        self._error_logged = False
        self.n_failed_polls = 0

    def is_live(self) -> bool:
        return self.mode == "streaming"

    def _read_rows(self) -> dict[Any, tuple]:
        colnames = self.schema.column_names()
        dtypes = self.schema.dtypes()
        pk = self.schema.primary_key_columns()
        raw = self.settings.http(
            f"SELECT {', '.join(_q(c) for c in colnames)} "
            f"FROM {_q(self.table_name)} FORMAT JSONEachRow"
        )
        out: dict[Any, tuple] = {}
        occurrence: dict[tuple, int] = {}
        for ln in raw.decode().splitlines():
            if not ln.strip():
                continue
            d = json.loads(ln)
            row = tuple(coerce_value(d.get(c), dtypes[c]) for c in colnames)
            if pk:
                key = ref_scalar(*[d.get(c) for c in pk])
            else:
                occ = occurrence.get(row, 0)
                occurrence[row] = occ + 1
                key = ref_scalar("#chrow", *row, occ)
            out[key] = row
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
                _log.warning("clickhouse poll failed for %s: %s",
                             self.table_name, exc)
                self._error_logged = True
            return []


def read(settings: ClickHouseSettings, table_name: str,
         schema: SchemaMetaclass, *, mode: str = "streaming",
         poll_interval_s: float | None = None,
         autocommit_duration_ms: int = 500, **kwargs) -> Table:
    _check_entitlements("clickhouse")
    if poll_interval_s is None:
        poll_interval_s = autocommit_duration_ms / 1000.0
    source = ClickHouseSource(settings, table_name, schema,
                              poll_interval_s, mode)
    return make_input_table(schema, source, name=f"clickhouse:{table_name}", persistent_id=kwargs.get("persistent_id"))


class _ClickHouseWriter:
    def __init__(self, settings: ClickHouseSettings, table_name: str, *,
                 snapshot: bool = False,
                 primary_key: list[str] | None = None,
                 init_mode: str = "default"):
        self.settings = settings
        self.table_name = table_name
        self.snapshot = snapshot
        self.primary_key = primary_key or []
        self.init_mode = init_mode
        self._initialized = False

    def _ensure(self, colnames: list[str], sample_row) -> None:
        if self._initialized:
            return
        self._initialized = True
        if self.init_mode in ("create_if_not_exists", "replace"):
            if self.init_mode == "replace":
                self.settings.http(
                    f"DROP TABLE IF EXISTS {_q(self.table_name)}"
                )
            cols = ", ".join(
                f"{_q(c)} {_ch_type(v)}"
                for c, v in zip(colnames, sample_row)
            )
            extra = "" if self.snapshot else ", `time` Int64, `diff` Int64"
            order = (
                ", ".join(_q(c) for c in self.primary_key)
                if self.snapshot and self.primary_key else "tuple()"
            )
            self.settings.http(
                f"CREATE TABLE IF NOT EXISTS {_q(self.table_name)} "
                f"({cols}{extra}) ENGINE = MergeTree ORDER BY ({order})"
            )

    def write_batch(self, time_, colnames, updates) -> None:
        if not updates:
            return
        first_vals = unwrap_row(updates[0][1])
        self._ensure(list(colnames), first_vals)
        tbl = _q(self.table_name)
        if not self.snapshot:
            lines = []
            for _key, row, diff in updates:
                d = dict(zip(colnames, (plain_scalar(v) for v in unwrap_row(row))))
                d["time"] = time_
                d["diff"] = diff
                lines.append(json.dumps(d))
            self.settings.http(
                f"INSERT INTO {tbl} FORMAT JSONEachRow",
                ("\n".join(lines) + "\n").encode(),
            )
            return
        pk = self.primary_key or [list(colnames)[0]]
        inserts = []
        for _key, row, diff in updates:
            vals = [plain_scalar(v) for v in unwrap_row(row)]
            d = dict(zip(colnames, vals))
            if diff > 0:
                inserts.append(json.dumps(d))
            else:
                cond = " AND ".join(
                    f"{_q(c)} = {_sql_lit(d[c])}" for c in pk
                )
                self.settings.http(
                    f"ALTER TABLE {tbl} DELETE WHERE {cond}"
                )
        if inserts:
            self.settings.http(
                f"INSERT INTO {tbl} FORMAT JSONEachRow",
                ("\n".join(inserts) + "\n").encode(),
            )

    def close(self) -> None:
        pass


def _sql_lit(v) -> str:
    if isinstance(v, str):
        return "'" + v.replace("\\", "\\\\").replace("'", "\\'") + "'"
    if v is None:
        return "NULL"
    return str(v)


def write(table: Table, settings: ClickHouseSettings, table_name: str, *,
          init_mode: str = "default",
          output_table_type: str = "stream_of_changes",
          primary_key: Iterable[Any] | None = None, **kwargs) -> None:
    pk_names = [getattr(c, "_name", c) for c in (primary_key or [])]
    pg.new_output_node(
        "output", [table], colnames=table.column_names(),
        writer=_ClickHouseWriter(
            settings, table_name,
            snapshot=(output_table_type == "snapshot"),
            primary_key=pk_names, init_mode=init_mode,
        ),
    )


def write_snapshot(table: Table, settings: ClickHouseSettings,
                   table_name: str, primary_key: Iterable[Any], *,
                   init_mode: str = "default", **kwargs) -> None:
    write(table, settings, table_name, init_mode=init_mode,
          output_table_type="snapshot", primary_key=primary_key)
