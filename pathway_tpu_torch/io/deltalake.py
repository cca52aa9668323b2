"""Delta Lake connector: a native implementation of the Delta transaction-log
protocol over parquet data files (reference:
src/connectors/data_storage/data_lake/delta.rs, 1,766 LoC + data_lake/mod.rs).

No `deltalake` client dependency: the protocol is files — parquet parts plus
an ordered JSON commit log under `_delta_log/{version:020d}.json` whose
actions (protocol / metaData / add / remove / commitInfo) define the table
state.  Tables written here are readable by delta-rs/Spark readers (minimal
reader version 1), and `read` consumes tables written by any Delta writer.

Write modes (reference parity, delta.rs TableWriter):
  - stream_of_changes (default): every update appends a row with `time` and
    `diff` columns — the table is the change log.
  - snapshot: rows carry the live snapshot; each batch commits `add` files
    for upserts and rewrites are expressed with remove+add on the pk.
    (Implemented as change-append with diff, plus compaction left to the
    lake engine, as the reference does for non-append sinks.)

Read: the active file set is the fold of add/remove actions at the latest
version; in streaming mode the log is tailed and each new version's files
are emitted incrementally (append-only Delta ingest), with `remove` actions
retracting the removed file's rows.  The resume offset is the last applied
log version.

The port of ``pathway_tpu/io/deltalake.py``.  A part loaded before a resume
and vacuumed since cannot be retracted: as there, that is a warning, and
here it is also counted in ``n_unretracted_parts``.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import time
import uuid
from typing import Any

from ..internals import dtype as dt
from ..internals import parse_graph as pg
from ..internals.datasource import DataSource
from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from ..internals.value import ref_scalar
from ..engine.types import unwrap_row
from ._utils import coerce_value, make_input_table, plain_scalar
from ..internals.config import _check_entitlements

_LOG_DIR = "_delta_log"
_log = logging.getLogger("pathway_tpu_torch.io.deltalake")


def _delta_type(d: dt.DType) -> str:
    t = d.strip_optional()
    if t == dt.INT:
        return "long"
    if t == dt.FLOAT:
        return "double"
    if t == dt.BOOL:
        return "boolean"
    if t == dt.BYTES:
        return "binary"
    if t == dt.DATE_TIME_NAIVE or t == dt.DATE_TIME_UTC:
        return "timestamp"
    return "string"


def _schema_string(colnames: list[str], dtypes: dict) -> str:
    fields = [
        {
            "name": c,
            "type": _delta_type(dtypes.get(c, dt.STR)),
            "nullable": True,
            "metadata": {},
        }
        for c in colnames
    ]
    return json.dumps({"type": "struct", "fields": fields})


def _log_path(base: str, version: int) -> str:
    return os.path.join(base, _LOG_DIR, f"{version:020d}.json")


def _list_versions(base: str) -> list[int]:
    out = []
    for p in glob.glob(os.path.join(base, _LOG_DIR, "*.json")):
        stem = os.path.basename(p).split(".")[0]
        if stem.isdigit():
            out.append(int(stem))
    return sorted(out)


def _read_actions(base: str, version: int) -> list[dict]:
    with open(_log_path(base, version)) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


class DeltaWriter:
    """Commit-per-batch Delta writer: one parquet part + one log version."""

    def __init__(self, path: str, colnames: list[str], dtypes: dict,
                 partition_columns: list[str] | None = None):
        self.path = path
        self.colnames = list(colnames)
        self.dtypes = dict(dtypes)
        self.partition_columns = list(partition_columns or [])
        os.makedirs(os.path.join(path, _LOG_DIR), exist_ok=True)
        self._version = (_list_versions(path) or [-1])[-1]
        if self._version < 0:
            self._commit_protocol()

    def _commit_protocol(self) -> None:
        actions = [
            {"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}},
            {
                "metaData": {
                    "id": str(uuid.uuid4()),
                    "format": {"provider": "parquet", "options": {}},
                    "schemaString": _schema_string(
                        self.colnames + ["time", "diff"],
                        {**self.dtypes, "time": dt.INT, "diff": dt.INT},
                    ),
                    "partitionColumns": self.partition_columns,
                    "configuration": {},
                    "createdTime": int(time.time() * 1000),
                }
            },
        ]
        self._append_commit(actions)

    def _append_commit(self, actions: list[dict]) -> None:
        self._version += 1
        tmp = _log_path(self.path, self._version) + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            for a in actions:
                f.write(json.dumps(a) + "\n")
        # atomic publish: the commit exists fully or not at all
        os.replace(tmp, _log_path(self.path, self._version))

    def write_batch(self, time_: int, colnames, updates: list) -> None:
        if not updates:
            return
        import pyarrow as pa
        import pyarrow.parquet as pq

        cols: dict[str, list] = {c: [] for c in self.colnames}
        cols["time"] = []
        cols["diff"] = []
        for _key, row, diff in updates:
            vals = unwrap_row(row)
            for c, v in zip(self.colnames, vals):
                cols[c].append(plain_scalar(v, keep_bytes=True))
            cols["time"].append(time_)
            cols["diff"].append(diff)
        table = pa.table(cols)
        fname = f"part-00000-{uuid.uuid4()}-c000.snappy.parquet"
        fpath = os.path.join(self.path, fname)
        pq.write_table(table, fpath)
        self._append_commit([
            {
                "add": {
                    "path": fname,
                    "partitionValues": {},
                    "size": os.path.getsize(fpath),
                    "modificationTime": int(time.time() * 1000),
                    "dataChange": True,
                }
            },
            {
                "commitInfo": {
                    "timestamp": int(time.time() * 1000),
                    "operation": "WRITE",
                    "operationParameters": {"mode": "Append"},
                    "engineInfo": "pathway-tpu",
                }
            },
        ])

    def close(self) -> None:
        pass




def write(table: Table, uri: str, *,
          partition_columns: list | None = None,
          output_table_type: str = "stream_of_changes", **kwargs) -> None:
    """Reference: pw.io.deltalake.write (io/deltalake/__init__.py over
    delta.rs)."""
    _check_entitlements("deltalake")
    part_names = [getattr(c, "_name", c) for c in (partition_columns or [])]
    writer = DeltaWriter(
        uri, table.column_names(), dict(table._dtypes),
        partition_columns=part_names,
    )
    pg.new_output_node(
        "output", [table], colnames=table.column_names(), writer=writer
    )


class DeltaSource(DataSource):
    """Tail the Delta log: emit active files' rows, then follow new commits.

    Each `add` action ingests that parquet file's rows; each `remove`
    retracts them (file-granular, as the protocol defines).  The offset
    frontier is the last applied version, so restarts resume mid-log."""

    def __init__(self, path: str, schema: SchemaMetaclass, mode: str,
                 poll_interval_s: float = 0.5,
                 has_diff_columns: bool | None = None):
        self.path = path
        self.schema = schema
        self.mode = mode
        self.poll_interval_s = poll_interval_s
        self.has_diff_columns = has_diff_columns
        self._applied = -1  # last log version folded into the stream
        self._file_rows: dict[str, list] = {}  # path -> [(key, row)]
        self._autokey = 0
        self._last_poll = 0.0
        self._first = True
        self.n_unretracted_parts = 0

    def is_live(self) -> bool:
        return self.mode == "streaming"

    # -- offsets -----------------------------------------------------------
    def get_offsets(self) -> dict:
        return {"delta_version": str(self._applied)}

    def seek(self, offsets: dict) -> None:
        v = offsets.get("delta_version")
        if v is not None:
            self._applied = int(v)
            # re-materialize rows of files added up to the applied version
            # (their rows were already delivered pre-restart, but a later
            # `remove` action must be able to retract them — an empty entry
            # would make the retraction a silent no-op)
            for ver in _list_versions(self.path):
                if ver > self._applied:
                    break
                for a in _read_actions(self.path, ver):
                    if "add" in a:
                        # lazy: rows materialize only if a remove for this
                        # part ever arrives (parts persist until vacuum);
                        # eager loading would scan the whole table on every
                        # resume
                        self._file_rows[a["add"]["path"]] = None
                    elif "remove" in a:
                        self._file_rows.pop(a["remove"]["path"], None)

    # -- log folding -------------------------------------------------------
    def _rows_of(self, fname: str) -> list:
        import pyarrow.parquet as pq

        colnames = self.schema.column_names()
        dtypes = self.schema.dtypes()
        pk = self.schema.primary_key_columns()
        fpath = os.path.join(self.path, fname)
        table = pq.read_table(fpath)
        data = table.to_pydict()
        n = table.num_rows
        present = set(table.column_names)
        diffed = (
            self.has_diff_columns
            if self.has_diff_columns is not None
            else ("diff" in present and "time" in present)
        )
        out = []
        for i in range(n):
            row = tuple(
                coerce_value(data[c][i] if c in present else None, dtypes[c])
                for c in colnames
            )
            diff = int(data["diff"][i]) if diffed else 1
            if pk:
                key = ref_scalar(*[data[c][i] for c in pk])
            else:
                key = ref_scalar("#delta", fname, i)
            out.append((key, row, diff))
        return out

    def _apply_new_versions(self) -> list:
        events = []
        for ver in _list_versions(self.path):
            if ver <= self._applied:
                continue
            for a in _read_actions(self.path, ver):
                if "add" in a:
                    fname = a["add"]["path"]
                    rows = self._rows_of(fname)
                    self._file_rows[fname] = rows
                    for key, row, diff in rows:
                        events.append((0, key, row, diff))
                elif "remove" in a:
                    fname = a["remove"]["path"]
                    rows = self._file_rows.pop(fname, [])
                    if rows is None:  # added pre-resume: load lazily now
                        try:
                            rows = self._rows_of(fname)
                        except OSError:
                            self.n_unretracted_parts += 1
                            _log.warning(
                                "delta part %s already vacuumed; cannot "
                                "retract its rows", fname,
                            )
                            rows = []
                    for key, row, diff in rows:
                        events.append((0, key, row, -diff))
            self._applied = ver
        return events

    def static_events(self) -> list:
        if self.mode == "streaming":
            return []
        return self._apply_new_versions()

    def poll(self):
        now = time.monotonic()
        if not self._first and now - self._last_poll < self.poll_interval_s:
            return []
        self._first = False
        self._last_poll = now
        return self._apply_new_versions()


def read(
    uri: str,
    schema: SchemaMetaclass,
    *,
    mode: str = "streaming",
    autocommit_duration_ms: int = 500,
    poll_interval_s: float | None = None,
    has_diff_columns: bool | None = None,
    **kwargs,
) -> Table:
    """Reference: pw.io.deltalake.read."""
    _check_entitlements("deltalake")
    if poll_interval_s is None:
        poll_interval_s = autocommit_duration_ms / 1000.0
    source = DeltaSource(
        uri, schema, mode, poll_interval_s=poll_interval_s,
        has_diff_columns=has_diff_columns,
    )
    return make_input_table(schema, source, name=f"deltalake:{uri}", persistent_id=kwargs.get("persistent_id"))
