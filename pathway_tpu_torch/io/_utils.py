"""Shared connector plumbing: value coercion, input tables, file polling.

The part of ``pathway_tpu/io/_utils.py`` that ``io.fs``, ``io.csv``,
``io.jsonlines``, ``io.python`` and ``io.http`` stand on (reference:
src/connectors/data_format/ and the Reader trait,
src/connectors/data_storage/mod.rs:516), with the file writers and what
persistence needs of them: the file source's offsets and object cache,
and a writer's snapshot resume.  Cluster partitioning of the scan is not
ported: this package runs one process.
"""

from __future__ import annotations

import contextlib
import csv as _csv
import glob
import inspect
import io as _io
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
from ..internals.value import (
    ERROR,
    Json,
    Pointer,
    ref_scalar,
    ref_scalar_batch_rows,
)

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
                     name: str = "io", persistent_id: str | None = None
                     ) -> Table:
    if persistent_id is not None:
        # the opt-in marker of selective_persisting (reference: connectors
        # with explicit persistent ids are the only ones persisted then)
        source.persistent_id = persistent_id
    node = pg.new_node("input", [], source=source)
    return Table(node, schema.column_names(), dict(schema.dtypes()),
                 Universe(), name=name)


def events_from_dicts(
    dicts: Iterable[dict], schema: SchemaMetaclass, time: int = 0,
    seed: str = "io", start_index: int = 0,
) -> list:
    """Input events for ``dicts[start_index:]``.  With a primary key a row's
    key hashes its coerced key values (``ref_scalar``, batched through the
    native tier); without one it is the native ``hash_rows`` of the row's
    global index, ``seed`` and its content (``_auto_keys``), so a resumed
    read of a growing file keys its old rows as before.  Both are the JAX
    package's keys bit for bit."""
    colnames = schema.column_names()
    dtypes = schema.dtypes()
    pk = schema.primary_key_columns()
    dicts = list(dicts)[start_index:]
    rows = [tuple(coerce_value(d.get(c), dtypes[c]) for c in colnames)
            for d in dicts]
    if pk:
        # an unparseable key value keys by its raw value, so distinct bad
        # rows never collapse onto the ERROR sentinel's key
        pk_idx = [colnames.index(c) for c in pk]
        kval_rows = [[row[j] if row[j] is not ERROR else d.get(colnames[j])
                      for j in pk_idx] for d, row in zip(dicts, rows)]
        keys = ref_scalar_batch_rows(kval_rows, len(pk_idx))
        if keys is None:
            keys = [ref_scalar(*kv) for kv in kval_rows]
    else:
        keys = _auto_keys(dicts, seed, start_index)
    return [(time, key, row, 1) for key, row in zip(keys, rows)]


def _auto_keys(dicts: list[dict], seed: str, start_index: int = 0) -> list:
    """Keys of rows without a primary key: ``hash_rows`` over (global
    index, ``seed``, the row's sorted items' ``repr``), as the JAX
    package's ``io/_utils._auto_keys``."""
    n = len(dicts)
    if n == 0:
        return []
    import numpy as np

    from .. import native

    payloads = [repr(sorted(d.items(), key=lambda kv: str(kv[0])))
                for d in dicts]
    hashed = native.hash_rows(
        [np.arange(start_index, start_index + n, dtype=np.int64),
         [seed] * n, payloads])
    return [Pointer(int(h)) for h in hashed]


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
    JAX package's source scans inside ``poll``.)

    Persistence: ``get_offsets`` reports the per-file offsets of the rows
    ``poll`` has returned, never of rows still queued from the scan
    thread (each scan queues its offsets with its rows), so a journal
    record's offsets cover exactly its events.  ``seek`` sets the offsets
    before the thread starts; rows of files already read then replay
    from the journal, and a file deleted while the process was down is
    not retracted.  With an ``object_cache`` (set by persistence), every
    file read is cached as the bytes parsed, a file that vanishes keeps
    its rows, and the rest of a cached file whose origin vanished before
    all its rows were emitted is served from the cache.  A deleted file
    whose rows this run does not all hold (emitted before a restart)
    keeps them, with a warning: retracting part of them would leave the
    rest stale.  A failing cache raises.
    """

    append_only = True
    # set by persistence wiring: raw objects cache (CachedObjectStorage) so
    # parsing survives source disappearance (cached_object_storage.rs)
    object_cache = None
    supports_object_cache = True

    def __init__(self, path: str, parse_file: Callable[[str], list[dict]],
                 schema: SchemaMetaclass, poll_interval_s: float = 0.5):
        self.path = path
        self.parse_file = parse_file
        self.schema = schema
        self.poll_interval_s = poll_interval_s
        self._seen: dict[str, float] = {}      # file -> mtime parsed
        self._progress: dict[str, int] = {}    # file -> rows scanned
        self._polled: dict[str, int] = {}      # file -> rows poll returned
        self._fails: dict[str, tuple[float, int]] = {}  # (mtime, count)
        self._emitted: dict[str, list] = {}    # file -> its events
        # files whose live rows are not all in _emitted (read before a
        # restart): their deletion keeps the rows
        self._partial: set[str] = set()
        self._partial_logged = False
        # (events, offsets after them) per scan, or a scan's error
        self._found: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        try:
            params = inspect.signature(parse_file).parameters
        except (TypeError, ValueError):
            params = {}
        self._parse_takes_data = "data" in params
        self._parse_takes_meta = "cached_metadata" in params
        # set by the format layer (fs.read with_metadata): the metadata
        # cached with each object, so cache-served rows carry the same
        # _metadata as live ones
        self.cache_metadata_fn = None

    def is_live(self) -> bool:
        return True

    # -- offset frontier (persistence) ------------------------------------
    def get_offsets(self) -> dict:
        return dict(self._polled)

    def seek(self, offsets: dict) -> None:
        if self._thread is not None:
            raise RuntimeError("seek() after the scan thread started")
        self._progress = dict(offsets)
        self._polled = dict(offsets)
        self._seen = {}

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
                    self._found.put((events, dict(self._progress)))
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
            events.extend(found[0])
            self._polled = found[1]

    def _files(self) -> list[str]:
        if os.path.isdir(self.path):
            out = []
            for root, _dirs, files in os.walk(self.path):
                out.extend(os.path.join(root, f) for f in files)
            return sorted(out)
        return sorted(glob.glob(self.path))

    # -- the object cache --------------------------------------------------
    def _cache_put(self, f: str, mtime: float, payload: bytes) -> None:
        """Store the exact bytes that were parsed (a file rewritten
        between parse and cache would else be stored under the stale
        version)."""
        meta = (self.cache_metadata_fn(f)
                if self.cache_metadata_fn is not None else {"mtime": mtime})
        if isinstance(meta, Json):
            meta = meta.value
        self.object_cache.put(f, payload, version=mtime, metadata=meta)

    def _parse_cached(self, uri: str, payload: bytes) -> list[dict]:
        if self._parse_takes_meta:
            return self.parse_file(
                uri, data=payload,
                cached_metadata=Json(self.object_cache.metadata(uri)))
        return self.parse_file(uri, data=payload)

    def _cached_events(self) -> list:
        """Rows of cached objects whose origin vanished before all their
        rows were emitted (a crash between a read and its ingest)."""
        if self.object_cache is None or not self._parse_takes_data:
            return []
        events = []
        for uri in self.object_cache.list_uris():
            if os.path.exists(uri) or uri in self._seen:
                continue
            payload = self.object_cache.get(uri)
            if payload is None:
                continue
            dicts = self._parse_cached(uri, payload)
            self._seen[uri] = -1.0  # cache-served; origin gone
            start = self._progress.get(uri, 0)
            if len(dicts) <= start:
                continue
            events.extend(events_from_dicts(dicts, self.schema, seed=uri,
                                            start_index=start))
            self._progress[uri] = len(dicts)
        return events

    def _deleted(self, f: str, events: list) -> None:
        """``f`` left the listing: its rows are retracted, or kept (a
        cached or partially held file)."""
        if self._seen.get(f) == -1.0:
            return  # cache-served: the origin was already gone
        if self.object_cache is not None and self.object_cache.contains(f):
            # cached origin: its rows keep serving
            self._seen[f] = -1.0
            self._emitted.pop(f, None)
            return
        if f in self._partial or (
                f not in self._emitted and self._progress.get(f, 0) > 0):
            # not every live row of f is held here: keep all of them and
            # the offsets, so a recreated file cannot re-emit their keys
            self._emitted.pop(f, None)
            self._partial.add(f)
            if not self._partial_logged:
                self._partial_logged = True
                logging.getLogger(__name__).warning(
                    "deleted file %s had rows ingested before a restart; "
                    "its rows are kept (only files read whole in this run "
                    "retract)", f)
            return
        for (t, key, row, diff) in self._emitted.pop(f, ()):
            events.append((t, key, row, -diff))
        self._seen.pop(f, None)
        self._progress.pop(f, None)
        self._fails.pop(f, None)

    def _read(self, f: str) -> tuple[list[dict], bytes | None]:
        """``f``'s rows, and the bytes they were parsed from when they go
        to the object cache."""
        if self.object_cache is not None and self._parse_takes_data:
            # one read: the same bytes feed the parse and the cache
            with open(f, "rb") as fh:
                payload = fh.read()
            return self.parse_file(f, data=payload), payload
        return self.parse_file(f), None

    def scan(self) -> list:
        """One pass over the path: the events of new rows, and the
        retractions of deleted files."""
        cache = self.object_cache
        with (cache.deferred() if cache is not None
              else contextlib.nullcontext()):
            events = self._cached_events()
            listed = self._files()
            current = set(listed)
            for f in [f for f in self._seen if f not in current]:
                self._deleted(f, events)
            for f in listed:
                try:
                    mtime = os.path.getmtime(f)
                except OSError:
                    continue  # deleted since the listing
                if self._seen.get(f) == mtime:
                    continue
                try:
                    dicts, payload = self._read(f)
                except (OSError, ValueError) as exc:
                    fm, fc = self._fails.get(f, (mtime, 0))
                    fc = fc + 1 if fm == mtime else 1
                    self._fails[f] = (mtime, fc)
                    if fc >= PARSE_ATTEMPTS:
                        logging.getLogger(__name__).warning(
                            "giving up parsing %s after %d failures at the "
                            "same mtime (%s); skipping until the file "
                            "changes", f, fc, exc)
                        self._seen[f] = mtime
                    continue
                if payload is not None:
                    self._cache_put(f, mtime, payload)
                self._fails.pop(f, None)
                self._seen[f] = mtime
                start = self._progress.get(f, 0)
                if len(dicts) <= start:
                    continue
                new = events_from_dicts(dicts, self.schema, seed=f,
                                        start_index=start)
                self._progress[f] = len(dicts)
                # a cached file's deletion keeps its rows: nothing to track
                if payload is None:
                    if f in self._partial or (start > 0
                                              and f not in self._emitted):
                        self._partial.add(f)  # rows [0, start) predate us
                    else:
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
    """Base sink writing consolidated update batches, one line an update.

    The file opens at the first write, so an operator-snapshot restore can
    trim the previous run's output first (``resume``, called by
    ``persistence/snapshots.py``)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None
        self._mode = "w"
        self._lock = threading.Lock()

    def _ensure_open(self):
        if self._fh is None:
            self._fh = open(self.path, self._mode, encoding="utf-8")

    def write_batch(self, time: int, colnames: list[str], updates: list) -> None:
        with self._lock:
            self._ensure_open()
            for key, row, diff in updates:
                self.write_row(time, colnames, key, unwrap_row(row), diff)
            self._fh.flush()

    def write_row(self, time, colnames, key, row, diff):
        raise NotImplementedError

    def resume(self, keep_le_time: int) -> None:
        """Exactly-once resume: drop the entries of times after the
        restored snapshot frontier (the journal tail's replay writes them
        again), keep the rest, and append from here on (reference: the
        persistence metadata tracker's committed output frontiers,
        src/persistence/tracker.rs:51-275).  Only the last entry may be
        torn (a crash mid-write; its time is past the frontier, since a
        snapshot follows its time's flush): it is dropped.  Any other
        entry that does not parse raises."""
        with self._lock:
            if self._fh is not None:
                raise RuntimeError("resume() must precede the first write")
            if os.path.exists(self.path):
                kept = self._filter_lines(self.path, keep_le_time)
                tmp = f"{self.path}.tmp"
                with open(tmp, "w", encoding="utf-8", newline="") as f:
                    f.writelines(kept)
                os.replace(tmp, self.path)
                self._mode = "a"

    def _filter_lines(self, path: str, keep_le_time: int) -> list[str]:
        raise NotImplementedError

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def _torn(path: str, what: str, i: int, n: int, exc: Exception) -> None:
    """Entry ``i`` of ``n`` did not parse: a torn last entry is dropped."""
    if i != n - 1:
        raise ValueError(
            f"{path}: {what} {i + 1} of {n} does not parse ({exc}); only a "
            "torn last entry is dropped on resume") from exc
    logging.getLogger(__name__).warning(
        "%s: dropping the torn last %s on resume (%s)", path, what, exc)


class JsonlinesWriter(FileWriter):
    def write_row(self, time, colnames, key, row, diff):
        obj = dict(zip(colnames, [_jsonable(v) for v in row]))
        obj["time"] = time
        obj["diff"] = diff
        self._fh.write(json.dumps(obj, default=str) + "\n")

    def _filter_lines(self, path, keep_le_time):
        with open(path, encoding="utf-8") as f:
            lines = f.readlines()
        kept = []
        for i, ln in enumerate(lines):
            try:
                t = json.loads(ln)["time"]
            except (ValueError, KeyError, TypeError) as exc:
                _torn(path, "line", i, len(lines), exc)
                continue
            if t <= keep_le_time:
                kept.append(ln)
        return kept


class CsvWriter(FileWriter):
    def __init__(self, path: str):
        super().__init__(path)
        self._writer = None

    def write_row(self, time, colnames, key, row, diff):
        if self._writer is None:
            self._writer = _csv.writer(self._fh)
            if self._mode == "w":
                self._writer.writerow(list(colnames) + ["time", "diff"])
        self._writer.writerow([_csvable(v) for v in row] + [time, diff])

    def _filter_lines(self, path, keep_le_time):
        # parsed with the csv module: quoted fields may span lines
        with open(path, encoding="utf-8", newline="") as f:
            rows = list(_csv.reader(f))
        if not rows:
            return []
        out = _io.StringIO()
        w = _csv.writer(out)
        w.writerow(rows[0])  # header
        n = len(rows) - 1
        for i, r in enumerate(rows[1:]):
            try:
                t, _diff = int(r[-2]), int(r[-1])
                if len(r) != len(rows[0]):
                    raise ValueError(f"{len(r)} fields, header {len(rows[0])}")
            except (ValueError, IndexError) as exc:
                _torn(path, "row", i, n, exc)
                continue
            if t <= keep_le_time:
                w.writerow(r)
        return [out.getvalue()]


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
