"""Shared connector plumbing: value coercion, input tables, file polling.

The part of ``pathway_tpu/io/_utils.py`` that ``io.fs``, ``io.csv``,
``io.jsonlines``, ``io.python`` and ``io.http`` stand on (reference:
src/connectors/data_format/ and the Reader trait,
src/connectors/data_storage/mod.rs:516), with the file writers.  The
object cache, a writer's snapshot resume and cluster partitioning of the
scan are not ported: this package runs one process without persistence.
"""

from __future__ import annotations

import csv as _csv
import glob
import json
import logging
import os
import queue
import threading
import time
from typing import Any, Callable, Iterable

from ..engine.types import unwrap_row
from ..internals import dtype as dt
from ..internals import parse_graph as pg
from ..internals.datasource import DataSource, StaticDataSource
from ..internals.schema import SchemaMetaclass
from ..internals.table import Table, Universe
from ..internals.value import ERROR, Json, ref_scalar

# a file that fails to parse this many times at one mtime is skipped
# until it changes (a file mid-write fails once or twice)
PARSE_ATTEMPTS = 5


def coerce_value(v: Any, d: dt.DType):
    if v is None:
        return None
    t = d.strip_optional()
    try:
        if t == dt.INT:
            return int(v)
        if t == dt.FLOAT:
            return float(v)
        if t == dt.BOOL:
            if isinstance(v, bool):
                return v
            return str(v).strip().lower() in ("true", "1", "yes", "on")
        if t == dt.STR:
            return v if isinstance(v, str) else str(v)
        if t == dt.BYTES:
            return v if isinstance(v, bytes) else str(v).encode()
        if t == dt.JSON:
            if isinstance(v, Json):
                return v
            if isinstance(v, (dict, list, int, float, bool)):
                return Json(v)
            return Json.parse(v)
    except (ValueError, TypeError):
        return ERROR
    return v


def make_input_table(schema: SchemaMetaclass, source: DataSource,
                     name: str = "io") -> Table:
    node = pg.new_node("input", [], source=source)
    return Table(node, schema.column_names(), dict(schema.dtypes()),
                 Universe(), name=name)


def events_from_dicts(
    dicts: Iterable[dict], schema: SchemaMetaclass, time: int = 0,
    seed: str = "io", start_index: int = 0,
) -> list:
    """Input events for ``dicts[start_index:]``.  With a primary key a row's
    key hashes its coerced key values; without one it hashes ``seed``,
    the row's global index and its content, so a resumed read of a
    growing file keys its old rows as before."""
    colnames = schema.column_names()
    dtypes = schema.dtypes()
    pk = schema.primary_key_columns()
    pk_idx = [colnames.index(c) for c in pk] if pk else None
    events = []
    for i, d in enumerate(list(dicts)[start_index:], start_index):
        row = tuple(coerce_value(d.get(c), dtypes[c]) for c in colnames)
        if pk_idx:
            # an unparseable key value keys by its raw value, so distinct
            # bad rows never collapse onto the ERROR sentinel's key
            key = ref_scalar(*[row[j] if row[j] is not ERROR
                               else d.get(colnames[j]) for j in pk_idx])
        else:
            key = ref_scalar(seed, i, repr(sorted(d.items(),
                                                  key=lambda kv: str(kv[0]))))
        events.append((time, key, row, 1))
    return events


class FilePollingSource(DataSource):
    """Streaming-mode file source: re-scan the path, emit only new rows.

    Reference: src/connectors/scanner/filesystem.rs + polling.rs.  File
    content is append-only: per-file row offsets track what was already
    emitted.  A deleted file's rows are retracted; a file that fails to
    parse is retried on later scans, and skipped after
    ``PARSE_ATTEMPTS`` failures at one modification time.

    The scans run on the source's own thread and ``poll`` drains what
    they found: a scan lists every file and reads each one's
    modification time, which costs seconds over tens of thousands of
    files, and the runner's thread (which also answers queries) never
    waits for it.  After a scan the thread waits ``poll_interval_s``, or
    as long as that scan took if longer, so scanning holds at most half
    of the time it competes with the runner for the interpreter.  A scan
    that raises ends the thread, and ``poll`` raises its error.  (The
    JAX package's source scans inside ``poll``.)"""

    append_only = True

    def __init__(self, path: str, parse_file: Callable[[str], list[dict]],
                 schema: SchemaMetaclass, poll_interval_s: float = 0.5):
        self.path = path
        self.parse_file = parse_file
        self.schema = schema
        self.poll_interval_s = poll_interval_s
        self._seen: dict[str, float] = {}      # file -> mtime parsed
        self._progress: dict[str, int] = {}    # file -> rows emitted
        self._fails: dict[str, tuple[float, int]] = {}  # (mtime, count)
        self._emitted: dict[str, list] = {}    # file -> its events
        self._found: queue.Queue = queue.Queue()  # event lists or an error
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def is_live(self) -> bool:
        return True

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._scan_loop,
                                            daemon=True, name="pw-fs-scan")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _scan_loop(self) -> None:
        try:
            while not self._stop.is_set():
                t0 = time.monotonic()
                events = self.scan()
                if events:
                    self._found.put(events)
                self._stop.wait(max(self.poll_interval_s,
                                    time.monotonic() - t0))
        except Exception as exc:  # noqa: BLE001 - raised by poll
            self._found.put(exc)

    def poll(self):
        events = []
        while True:
            try:
                found = self._found.get_nowait()
            except queue.Empty:
                return events
            if isinstance(found, BaseException):
                raise found
            events.extend(found)

    def _files(self) -> list[str]:
        if os.path.isdir(self.path):
            out = []
            for root, _dirs, files in os.walk(self.path):
                out.extend(os.path.join(root, f) for f in files)
            return sorted(out)
        return sorted(glob.glob(self.path))

    def scan(self) -> list:
        """One pass over the path: the events of new rows, and the
        retractions of deleted files."""
        events = []
        listed = self._files()
        current = set(listed)
        for f in [f for f in self._seen if f not in current]:
            for (t, key, row, diff) in self._emitted.pop(f, ()):
                events.append((t, key, row, -diff))
            self._seen.pop(f, None)
            self._progress.pop(f, None)
            self._fails.pop(f, None)
        for f in listed:
            try:
                mtime = os.path.getmtime(f)
            except OSError:
                continue  # deleted since the listing
            if self._seen.get(f) == mtime:
                continue
            try:
                dicts = self.parse_file(f)
            except (OSError, ValueError) as exc:
                fm, fc = self._fails.get(f, (mtime, 0))
                fc = fc + 1 if fm == mtime else 1
                self._fails[f] = (mtime, fc)
                if fc >= PARSE_ATTEMPTS:
                    logging.getLogger(__name__).warning(
                        "giving up parsing %s after %d failures at the same "
                        "mtime (%s); skipping until the file changes", f, fc,
                        exc)
                    self._seen[f] = mtime
                continue
            self._fails.pop(f, None)
            self._seen[f] = mtime
            start = self._progress.get(f, 0)
            if len(dicts) <= start:
                continue
            new = events_from_dicts(dicts, self.schema, seed=f,
                                    start_index=start)
            self._progress[f] = len(dicts)
            self._emitted.setdefault(f, []).extend(new)
            events.extend(new)
        return events


def _jsonable(v):
    if isinstance(v, Json):
        return v.value
    if isinstance(v, bytes):
        import base64

        return base64.b64encode(v).decode()
    import numpy as np

    from ..ops.device_store import DeviceVec

    if isinstance(v, DeviceVec):
        # writers materialize device-resident vectors
        return v.to_numpy().tolist()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


class FileWriter:
    """Base sink writing consolidated update batches, one line an update
    (the JAX package's ``FileWriter`` without its snapshot resume).  The
    file opens at the first write."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None
        self._lock = threading.Lock()

    def _ensure_open(self):
        if self._fh is None:
            self._fh = open(self.path, "w", encoding="utf-8")

    def write_batch(self, time: int, colnames: list[str], updates: list) -> None:
        with self._lock:
            self._ensure_open()
            for key, row, diff in updates:
                self.write_row(time, colnames, key, unwrap_row(row), diff)
            self._fh.flush()

    def write_row(self, time, colnames, key, row, diff):
        raise NotImplementedError

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class JsonlinesWriter(FileWriter):
    def write_row(self, time, colnames, key, row, diff):
        obj = dict(zip(colnames, [_jsonable(v) for v in row]))
        obj["time"] = time
        obj["diff"] = diff
        self._fh.write(json.dumps(obj, default=str) + "\n")


class CsvWriter(FileWriter):
    def __init__(self, path: str):
        super().__init__(path)
        self._writer = None

    def write_row(self, time, colnames, key, row, diff):
        if self._writer is None:
            self._writer = _csv.writer(self._fh)
            self._writer.writerow(list(colnames) + ["time", "diff"])
        self._writer.writerow([_csvable(v) for v in row] + [time, diff])


def _csvable(v):
    if isinstance(v, Json):
        return str(v)
    return v


def add_output_node(table: Table, writer) -> None:
    pg.new_output_node(
        "output", [table], colnames=table.column_names(), writer=writer
    )


def plain_scalar(v, keep_bytes: bool = False):
    """JSON/transport-safe scalar: passthrough primitives, unwrap Json,
    stringify the rest (shared by the sink connectors).  keep_bytes
    passes bytes through for binary-capable sinks."""
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    if keep_bytes and isinstance(v, (bytes, bytearray)):
        return bytes(v)
    if isinstance(v, Json):
        return v.value
    import numpy as np

    if isinstance(v, np.generic):
        return v.item()
    return str(v)
