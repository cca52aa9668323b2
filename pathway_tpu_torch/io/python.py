"""Custom Python sources (the port of ``pathway_tpu/io/python.py``;
reference: io/python/__init__.py:49 ConnectorSubject)."""

from __future__ import annotations

import csv
import json
import time
from typing import Any

from ..internals import dtype as dt
from ..internals.datasource import SubjectDataSource
from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from ._utils import coerce_value, make_input_table


class ConnectorSubject:
    """Subclass and implement run(); call self.next(**values) / next_json /
    next_str / next_bytes; the stream ends when run() returns.

    Persistence contract: ``deterministic_rerun`` is opt-in (default
    False).  A subject whose run() re-emits the same event stream on a
    restart (pure generators, file replays) may set it to True, and the
    persistence layer then skips the already-journaled prefix instead of
    ingesting it twice.  A broker- or push-style subject that delivers only
    new events after a restart must leave it False: a prefix skip would
    drop its first fresh events, where duplicates from a subject that is
    deterministic but left at False are at least visible.  A subject with
    real offsets implements seek() / get_offsets() instead; seek always
    wins."""

    deterministic_rerun = False

    _source: SubjectDataSource | None = None
    _colnames: list[str] = []
    _dtypes: dict[str, dt.DType] = {}

    def run(self) -> None:
        raise NotImplementedError

    # -- emit API ----------------------------------------------------------
    def _row(self, kwargs: dict) -> tuple:
        return tuple(coerce_value(kwargs.get(c), self._dtypes.get(c, dt.ANY))
                     for c in self._colnames)

    def next(self, **kwargs: Any) -> None:
        self._source.push(self._row(kwargs), 1, kwargs.get("_key"))

    def next_json(self, message: dict | str) -> None:
        if isinstance(message, str):
            message = json.loads(message)
        self.next(**message)

    def next_str(self, message: str) -> None:
        self.next(data=message)

    def next_bytes(self, message: bytes) -> None:
        self.next(data=message)

    def _remove(self, **kwargs: Any) -> None:
        self._source.push(self._row(kwargs), -1, kwargs.get("_key"))

    def remove(self, **kwargs: Any) -> None:
        self._remove(**kwargs)

    def close(self) -> None:
        pass  # the source closes when run() returns

    def commit(self) -> None:
        pass

    def on_stop(self) -> None:
        pass

    # driver hook
    def _run(self, source: SubjectDataSource) -> None:
        self._source = source
        try:
            self.run()
        finally:
            self.on_stop()


def read(
    subject: ConnectorSubject,
    *,
    schema: SchemaMetaclass,
    autocommit_duration_ms: int = 1500,
    name: str | None = None,
    **kwargs,
) -> Table:
    pk = schema.primary_key_columns()
    colnames = schema.column_names()
    pk_positions = [colnames.index(c) for c in pk] if pk else None
    source = SubjectDataSource(subject, colnames, pk_positions)
    subject._colnames = colnames
    subject._dtypes = dict(schema.dtypes())
    return make_input_table(schema, source, name=name or "python",
                            persistent_id=kwargs.get("persistent_id"))


class InteractiveCsvPlayer(ConnectorSubject):
    """Replays a CSV file's rows as a stream, one row every 10 ms divided
    by ``speedup``."""

    def __init__(self, csv_file: str, speedup: float = 1.0):
        self.csv_file = csv_file
        self.speedup = speedup

    def run(self):
        with open(self.csv_file, newline="") as f:
            for row in csv.DictReader(f):
                self.next(**row)
                time.sleep(0.01 / self.speedup)


__all__ = ["ConnectorSubject", "InteractiveCsvPlayer", "read"]
