"""PyFilesystem connector (reference: python/pathway/io/pyfilesystem/
__init__.py:159).

Reads files from any PyFilesystem-style `source` object — the user passes
the FS object (e.g. `fs.open_fs("osfs://...")` / a ZipFS / an FTPFS), so
there is no `fs` package dependency here.  The required surface is
duck-typed: a directory walk (`source.walk.files(path)` or
`listdir`/`isdir` recursion), `getinfo(path)` for details, and
`readbytes`/`getbytes`/`open` for content.  "streaming" mode polls every
`refresh_interval` seconds and emits additions, modifications (retract +
re-insert) and deletions; "static" ingests once.  format="binary" yields a
`data` column; "only_metadata" skips reading contents entirely.

The port of ``pathway_tpu/io/pyfilesystem.py``.  A failed scan is logged
once and retried at the next poll, and counted in ``n_failed_polls``.
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import Any, Literal

from ..internals import dtype as dt
from ..internals.datasource import DataSource
from ..internals.schema import ColumnDefinition, SchemaMetaclass, schema_from_columns
from ..internals.table import Table
from ..internals.value import Json, ref_scalar
from ._utils import make_input_table

_log = logging.getLogger("pathway_tpu_torch.io.pyfilesystem")


def _schema(format: str, with_metadata: bool) -> SchemaMetaclass:  # noqa: A002
    cols: dict[str, ColumnDefinition] = {}
    if format == "binary":
        cols["data"] = ColumnDefinition(dtype=dt.BYTES)
    if with_metadata or format == "only_metadata":
        cols["_metadata"] = ColumnDefinition(dtype=dt.JSON)
    return schema_from_columns(cols, name="PyFilesystemSchema")


def _walk_files(source, path: str) -> list[str]:
    walk = getattr(source, "walk", None)
    if walk is not None and hasattr(walk, "files"):
        return sorted(walk.files(path or "/"))
    out: list[str] = []

    def rec(p: str) -> None:
        for entry in source.listdir(p or "/"):
            full = (p.rstrip("/") + "/" + entry) if p else "/" + entry
            if source.isdir(full):
                rec(full)
            else:
                out.append(full)

    rec(path or "")
    return sorted(out)


def _ts(v) -> int | None:
    if isinstance(v, datetime.datetime):
        return int(v.timestamp())
    return int(v) if isinstance(v, (int, float)) else None


def _info(source, path: str) -> dict:
    try:
        info = source.getinfo(path, namespaces=["details"])
    except TypeError:
        info = source.getinfo(path)
    name = getattr(info, "name", path.rsplit("/", 1)[-1])
    return {
        "path": path,
        "name": name,
        "size": getattr(info, "size", None),
        "modified_at": _ts(getattr(info, "modified", None)),
        "created_at": _ts(getattr(info, "created", None)),
        "owner": getattr(info, "user", None),
        "seen_at": int(time.time()),
    }


def _read_bytes(source, path: str) -> bytes:
    for attr in ("readbytes", "getbytes"):
        fn = getattr(source, attr, None)
        if fn is not None:
            return fn(path)
    with source.open(path, "rb") as f:
        return f.read()


class PyFilesystemSource(DataSource):
    """Poll-and-diff over a PyFilesystem tree."""

    def __init__(self, source, path: str, *, format: str,  # noqa: A002
                 with_metadata: bool, refresh_interval_s: float, mode: str):
        self.source = source
        self.path = path
        self.format = format
        self.with_metadata = with_metadata
        self.refresh_interval_s = refresh_interval_s
        self.mode = mode
        self._emitted: dict[str, tuple] = {}   # path -> (fingerprint, row)
        self._last_poll = 0.0
        self._first = True
        self._error_logged = False
        self.n_failed_polls = 0

    def is_live(self) -> bool:
        return self.mode == "streaming"

    def _row_for(self, path: str, meta: dict) -> tuple:
        vals: list[Any] = []
        if self.format == "binary":
            vals.append(_read_bytes(self.source, path))
        if self.with_metadata or self.format == "only_metadata":
            vals.append(Json(meta))
        return tuple(vals)

    def _scan(self) -> list:
        # state commits only after a full successful scan, so an exception
        # mid-walk (transient FS error) can never lose an already-diffed
        # modification — the next scan re-detects it
        events = []
        emitted = dict(self._emitted)
        seen = set()
        for path in _walk_files(self.source, self.path):
            meta = _info(self.source, path)
            seen.add(path)
            fp = (meta["size"], meta["modified_at"])
            prev = emitted.get(path)
            if prev is not None and prev[0] == fp:
                continue
            key = ref_scalar("#pyfs", path)
            if prev is not None:
                events.append((0, key, prev[1], -1))
            row = self._row_for(path, meta)
            emitted[path] = (fp, row)
            events.append((0, key, row, 1))
        for path in list(emitted):
            if path not in seen:
                _fp, row = emitted.pop(path)
                events.append((0, ref_scalar("#pyfs", path), row, -1))
        self._emitted = emitted
        return events

    def static_events(self) -> list:
        if self.mode == "streaming":
            return []
        return self._scan()

    def poll(self):
        now = time.monotonic()
        if not self._first and now - self._last_poll < self.refresh_interval_s:
            return []
        self._first = False
        self._last_poll = now
        try:
            events = self._scan()
            self._error_logged = False
            return events
        except Exception as exc:
            self.n_failed_polls += 1
            if not self._error_logged:
                _log.warning(
                    "pyfilesystem scan failed: %s (stream idles until the "
                    "source is reachable again)", exc,
                )
                self._error_logged = True
            return []


def read(source, *, path: str = "",
         refresh_interval: float | datetime.timedelta = 30,
         mode: Literal["streaming", "static"] = "streaming",
         format: Literal["binary", "only_metadata"] = "binary",  # noqa: A002
         with_metadata: bool = False, name: str | None = None,
         max_backlog_size: int | None = None,
         persistent_id: str | None = None) -> Table:
    """Read a table from a PyFilesystem source."""
    if format not in ("binary", "only_metadata"):
        raise ValueError(f"unknown format {format!r}")
    if isinstance(refresh_interval, datetime.timedelta):
        refresh_interval = refresh_interval.total_seconds()
    sch = _schema(format, with_metadata)
    src = PyFilesystemSource(
        source, path, format=format, with_metadata=with_metadata,
        refresh_interval_s=float(refresh_interval), mode=mode,
    )
    return make_input_table(sch, src, name=name or "pyfilesystem", persistent_id=persistent_id)
