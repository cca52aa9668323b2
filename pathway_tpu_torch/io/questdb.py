"""QuestDB connector (reference: src/connectors/data_storage/questdb).

Write: InfluxDB line protocol over TCP (QuestDB's native ingest port 9009)
— `measurement,sym=val col=value ts` lines, one per row; escaping per the
ILP spec.  Read: the HTTP /exec endpoint returns query results as JSON
(snapshot-diff polling CDC like io/clickhouse.py).

The port of ``pathway_tpu/io/questdb.py``.  A failed poll is logged once
and retried at the next poll, and counted in ``n_failed_polls``.
"""

from __future__ import annotations

import json
import logging
import socket
import time
import urllib.parse
import urllib.request
from typing import Any

from ..engine.types import unwrap_row
from ..internals import parse_graph as pg
from ..internals.datasource import DataSource
from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from ..internals.value import ref_scalar
from ._utils import coerce_value, make_input_table
from ..internals.config import _check_entitlements

_log = logging.getLogger("pathway_tpu_torch.io.questdb")


def _esc_tag(s: str) -> str:
    return s.replace("\\", "\\\\").replace(",", "\\,").replace(
        " ", "\\ ").replace("=", "\\=")


def _field_value(v) -> str:
    if isinstance(v, bool):
        return "t" if v else "f"
    if isinstance(v, int):
        return f"{v}i"
    if isinstance(v, float):
        return repr(v)
    s = str(v).replace("\\", "\\\\").replace('"', '\\"')
    return f'"{s}"'


class _QuestDbWriter:
    def __init__(self, host: str, port: int, table_name: str,
                 designated_timestamp_policy: str = "now", _sock=None):
        self.host = host
        self.port = port
        self.table_name = table_name
        self.ts_policy = designated_timestamp_policy
        self._sock = _sock  # injectable for tests

    def _conn(self):
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=10
            )
        return self._sock

    def write_batch(self, time_, colnames, updates) -> None:
        lines = []
        table = _esc_tag(self.table_name)
        for _key, row, diff in updates:
            vals = unwrap_row(row)
            fields = ",".join(
                f"{_esc_tag(c)}={_field_value(v)}"
                for c, v in zip(colnames, vals)
            )
            fields += f",diff={diff}i,time={time_}i"
            ts = "" if self.ts_policy == "server" else f" {time.time_ns()}"
            lines.append(f"{table} {fields}{ts}\n")
        self._conn().sendall("".join(lines).encode())

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass


def write(table: Table, connection_string_or_host, *, table_name: str,
          port: int = 9009, **kwargs) -> None:
    _check_entitlements("questdb")
    host = connection_string_or_host
    if "://" in str(host):
        hostport = str(host).split("://", 1)[-1]
        host, _, p = hostport.partition(":")
        if p:
            port = int(p)
    pg.new_output_node(
        "output", [table], colnames=table.column_names(),
        writer=_QuestDbWriter(host, port, table_name,
                              _sock=kwargs.pop("_sock", None)),
    )


class QuestDbSource(DataSource):
    """Snapshot-diff CDC via the HTTP /exec JSON endpoint."""

    def __init__(self, http_url: str, table_name: str,
                 schema: SchemaMetaclass, poll_interval_s: float, mode: str,
                 _http=None):
        self.http_url = http_url.rstrip("/")
        self.table_name = table_name
        self.schema = schema
        self.poll_interval_s = poll_interval_s
        self.mode = mode
        self._http = _http
        self._snapshot: dict[Any, tuple] = {}
        self._last_poll = 0.0
        self._first = True
        self._err = False
        self.n_failed_polls = 0

    def is_live(self) -> bool:
        return self.mode == "streaming"

    def _exec(self, query: str) -> dict:
        if self._http is not None:
            return self._http(query)
        q = urllib.parse.urlencode({"query": query})
        with urllib.request.urlopen(
            f"{self.http_url}/exec?{q}", timeout=30
        ) as resp:
            return json.loads(resp.read())

    def _read_rows(self) -> dict[Any, tuple]:
        colnames = self.schema.column_names()
        dtypes = self.schema.dtypes()
        pk = self.schema.primary_key_columns()
        res = self._exec(
            "SELECT " + ", ".join(f'"{c}"' for c in colnames)
            + f' FROM "{self.table_name}"'
        )
        cols = [c["name"] for c in res.get("columns", [])]
        out: dict[Any, tuple] = {}
        occurrence: dict[tuple, int] = {}
        for raw in res.get("dataset", []):
            d = dict(zip(cols, raw))
            row = tuple(coerce_value(d.get(c), dtypes[c]) for c in colnames)
            if pk:
                key = ref_scalar(*[d.get(c) for c in pk])
            else:
                occ = occurrence.get(row, 0)
                occurrence[row] = occ + 1
                key = ref_scalar("#qdbrow", *row, occ)
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
            self._err = False
            return events
        except Exception as exc:
            self.n_failed_polls += 1
            if not self._err:
                _log.warning("questdb poll failed: %s", exc)
                self._err = True
            return []


def read(http_url: str, table_name: str, schema: SchemaMetaclass, *,
         mode: str = "streaming", poll_interval_s: float | None = None,
         autocommit_duration_ms: int = 500, **kwargs) -> Table:
    if poll_interval_s is None:
        poll_interval_s = autocommit_duration_ms / 1000.0
    source = QuestDbSource(
        http_url, table_name, schema, poll_interval_s, mode,
        _http=kwargs.pop("_http", None),
    )
    return make_input_table(schema, source, name=f"questdb:{table_name}", persistent_id=kwargs.get("persistent_id"))
