"""Apache Iceberg connector implementing the v1 table format natively
(reference: src/connectors/data_storage/data_lake/iceberg.rs, 1,426 LoC).

No pyiceberg: the format is files — parquet data, Avro manifests
(io/_avro.py), JSON table metadata with a version hint:

    table/metadata/version-hint.text        -> N
    table/metadata/vN.metadata.json         -> snapshots, schema
    table/metadata/snap-*.avro              -> manifest list
    table/metadata/manifest-*.avro          -> data-file entries
    table/data/*.parquet                    -> rows

`write` commits one snapshot per batch (parquet part + manifest + manifest
list + new metadata version).  `read` loads the current snapshot and tails
new ones; data files removed by a snapshot (manifest entry status=2)
retract their rows.  The resume offset is the last applied snapshot id.

The port of ``pathway_tpu/io/iceberg.py``; its manifests go through the
port's ``io/_avro.py``.  A failed poll is logged once and retried at the
next poll, and counted in ``n_failed_polls``.
"""

from __future__ import annotations

import json
import logging
import os
import time
import uuid
from typing import Any, Iterable

from ..engine.types import unwrap_row
from ..internals import dtype as dt
from ..internals import parse_graph as pg
from ..internals.datasource import DataSource
from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from ..internals.value import ref_scalar
from . import _avro
from ._utils import coerce_value, make_input_table, plain_scalar
from ..internals.config import _check_entitlements

_log = logging.getLogger("pathway_tpu_torch.io.iceberg")

_MANIFEST_ENTRY_SCHEMA = {
    "type": "record", "name": "manifest_entry", "fields": [
        {"name": "status", "type": "int", "field-id": 0},
        {"name": "snapshot_id", "type": ["null", "long"], "field-id": 1},
        {"name": "data_file", "field-id": 2, "type": {
            "type": "record", "name": "r2", "fields": [
                {"name": "file_path", "type": "string", "field-id": 100},
                {"name": "file_format", "type": "string", "field-id": 101},
                {"name": "record_count", "type": "long", "field-id": 103},
                {"name": "file_size_in_bytes", "type": "long",
                 "field-id": 104},
            ],
        }},
    ],
}

_MANIFEST_LIST_SCHEMA = {
    "type": "record", "name": "manifest_file", "fields": [
        {"name": "manifest_path", "type": "string", "field-id": 500},
        {"name": "manifest_length", "type": "long", "field-id": 501},
        {"name": "partition_spec_id", "type": "int", "field-id": 502},
        {"name": "added_snapshot_id", "type": ["null", "long"],
         "field-id": 503},
    ],
}


def _iceberg_type(d: dt.DType) -> str:
    t = d.strip_optional()
    if t == dt.INT:
        return "long"
    if t == dt.FLOAT:
        return "double"
    if t == dt.BOOL:
        return "boolean"
    if t == dt.BYTES:
        return "binary"
    return "string"


class _IcebergTable:
    """Metadata/version bookkeeping shared by reader and writer."""

    def __init__(self, path: str):
        self.path = path
        self.meta_dir = os.path.join(path, "metadata")
        self.data_dir = os.path.join(path, "data")

    def current_version(self) -> int:
        hint = os.path.join(self.meta_dir, "version-hint.text")
        try:
            with open(hint) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return 0

    def metadata(self, version: int | None = None) -> dict | None:
        v = version if version is not None else self.current_version()
        if v <= 0:
            return None
        p = os.path.join(self.meta_dir, f"v{v}.metadata.json")
        try:
            with open(p) as f:
                return json.load(f)
        except OSError:
            return None

    def snapshot_files(self, snapshot: dict) -> list[tuple[str, int]]:
        """[(data file path, status)] from the snapshot's manifest list."""
        ml_path = snapshot["manifest-list"]
        if not os.path.isabs(ml_path):
            ml_path = os.path.join(self.path, ml_path)
        with open(ml_path, "rb") as f:
            _meta, manifests = _avro.read_container(f.read())
        out = []
        for m in manifests:
            mp = m["manifest_path"]
            if not os.path.isabs(mp):
                mp = os.path.join(self.path, mp)
            with open(mp, "rb") as f:
                _mm, entries = _avro.read_container(f.read())
            for e in entries:
                out.append((e["data_file"]["file_path"], e["status"]))
        return out


class IcebergWriter:
    """Snapshot-per-batch writer (parquet + manifest + metadata commit)."""

    def __init__(self, path: str, colnames: list[str], dtypes: dict):
        self.t = _IcebergTable(path)
        self.colnames = list(colnames)
        self.dtypes = dict(dtypes)
        os.makedirs(self.t.meta_dir, exist_ok=True)
        os.makedirs(self.t.data_dir, exist_ok=True)

    def _schema_json(self) -> dict:
        cols = self.colnames + ["time", "diff"]
        types = {**self.dtypes, "time": dt.INT, "diff": dt.INT}
        return {
            "type": "struct", "schema-id": 0,
            "fields": [
                {"id": i + 1, "name": c, "required": False,
                 "type": _iceberg_type(types.get(c, dt.STR))}
                for i, c in enumerate(cols)
            ],
        }

    def write_batch(self, time_: int, colnames, updates: list) -> None:
        if not updates:
            return
        import pyarrow as pa
        import pyarrow.parquet as pq

        cols: dict[str, list] = {c: [] for c in self.colnames}
        cols["time"] = []
        cols["diff"] = []
        for _key, row, diff in updates:
            for c, v in zip(self.colnames, unwrap_row(row)):
                cols[c].append(plain_scalar(v, keep_bytes=True))
            cols["time"].append(time_)
            cols["diff"].append(diff)
        fname = f"data/{uuid.uuid4()}.parquet"
        fpath = os.path.join(self.t.path, fname)
        pq.write_table(pa.table(cols), fpath)

        snap_id = int(time.time() * 1000) * 1000 + self.t.current_version()
        manifest_name = f"metadata/manifest-{uuid.uuid4()}.avro"
        manifest = _avro.write_container(
            _MANIFEST_ENTRY_SCHEMA,
            [{
                "status": 1, "snapshot_id": snap_id,
                "data_file": {
                    "file_path": fname, "file_format": "PARQUET",
                    "record_count": len(updates),
                    "file_size_in_bytes": os.path.getsize(fpath),
                },
            }],
            metadata={"schema": json.dumps(self._schema_json())},
        )
        with open(os.path.join(self.t.path, manifest_name), "wb") as f:
            f.write(manifest)

        # new manifest list = previous snapshot's manifests + this one
        prev_meta = self.t.metadata()
        prev_manifests: list[dict] = []
        if prev_meta and prev_meta.get("current-snapshot-id", -1) != -1:
            for s in prev_meta.get("snapshots", []):
                if s["snapshot-id"] == prev_meta["current-snapshot-id"]:
                    ml = s["manifest-list"]
                    if not os.path.isabs(ml):
                        ml = os.path.join(self.t.path, ml)
                    with open(ml, "rb") as f:
                        _m, prev_manifests = _avro.read_container(f.read())
        ml_name = f"metadata/snap-{snap_id}-{uuid.uuid4()}.avro"
        ml = _avro.write_container(
            _MANIFEST_LIST_SCHEMA,
            list(prev_manifests) + [{
                "manifest_path": manifest_name,
                "manifest_length": len(manifest),
                "partition_spec_id": 0,
                "added_snapshot_id": snap_id,
            }],
        )
        with open(os.path.join(self.t.path, ml_name), "wb") as f:
            f.write(ml)

        version = self.t.current_version() + 1
        snapshots = (prev_meta or {}).get("snapshots", []) + [{
            "snapshot-id": snap_id,
            "timestamp-ms": int(time.time() * 1000),
            "manifest-list": ml_name,
            "summary": {"operation": "append"},
        }]
        meta = {
            "format-version": 1,
            "table-uuid": (prev_meta or {}).get(
                "table-uuid", str(uuid.uuid4())
            ),
            "location": self.t.path,
            "last-updated-ms": int(time.time() * 1000),
            "last-column-id": len(self.colnames) + 2,
            "schema": self._schema_json(),
            "partition-spec": [],
            "properties": {},
            "current-snapshot-id": snap_id,
            "snapshots": snapshots,
        }
        mpath = os.path.join(self.t.meta_dir, f"v{version}.metadata.json")
        tmp = mpath + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, mpath)
        with open(os.path.join(self.t.meta_dir, "version-hint.text"), "w") as f:
            f.write(str(version))

    def close(self) -> None:
        pass




def write(table: Table, catalog_uri_or_path: str, *, namespace=None,
          table_name: str | None = None, **kwargs) -> None:
    """Reference: pw.io.iceberg.write (filesystem-catalog tables; REST
    catalogs need a catalog service and are out of scope)."""
    _check_entitlements("iceberg")
    path = catalog_uri_or_path
    if table_name:
        parts = list(namespace or []) + [table_name]
        path = os.path.join(path, *parts)
    writer = IcebergWriter(path, table.column_names(), dict(table._dtypes))
    pg.new_output_node(
        "output", [table], colnames=table.column_names(), writer=writer
    )


class IcebergSource(DataSource):
    """Snapshot tailer: emits data files of the current snapshot, then
    follows new snapshots; files leaving the table retract their rows."""

    def __init__(self, path: str, schema: SchemaMetaclass, mode: str,
                 poll_interval_s: float = 0.5):
        self.t = _IcebergTable(path)
        self.schema = schema
        self.mode = mode
        self.poll_interval_s = poll_interval_s
        self._applied_snapshot = -1
        self._live_files: dict[str, list] = {}
        self._last_poll = 0.0
        self._first = True
        self._err = False
        self.n_failed_polls = 0

    def is_live(self) -> bool:
        return self.mode == "streaming"

    def get_offsets(self) -> dict:
        return {"iceberg_snapshot": str(self._applied_snapshot)}

    def seek(self, offsets: dict) -> None:
        v = offsets.get("iceberg_snapshot")
        if v is not None:
            self._applied_snapshot = int(v)
            meta = self.t.metadata()
            if meta:
                snap = self._snapshot_by_id(meta, self._applied_snapshot)
                if snap:
                    for fp, status in self.t.snapshot_files(snap):
                        if status != 2:
                            self._live_files[fp] = None  # lazy rows

    def _snapshot_by_id(self, meta: dict, sid: int) -> dict | None:
        for s in meta.get("snapshots", []):
            if s["snapshot-id"] == sid:
                return s
        return None

    def _rows_of(self, fname: str) -> list:
        import pyarrow.parquet as pq

        colnames = self.schema.column_names()
        dtypes = self.schema.dtypes()
        pk = self.schema.primary_key_columns()
        fpath = fname if os.path.isabs(fname) else os.path.join(
            self.t.path, fname
        )
        table = pq.read_table(fpath)
        data = table.to_pydict()
        present = set(table.column_names)
        diffed = "diff" in present and "time" in present
        out = []
        occurrence: dict[tuple, int] = {}
        for i in range(table.num_rows):
            row = tuple(
                coerce_value(data[c][i] if c in present else None, dtypes[c])
                for c in colnames
            )
            d = int(data["diff"][i]) if diffed else 1
            if pk:
                key = ref_scalar(*[data[c][i] for c in pk])
            else:
                # content+occurrence keys: a later file's diff=-1 row lands
                # on the same key as the earlier +1 with identical content,
                # so written retractions cancel their insertions (file-index
                # keys could never match across files); duplicates stay
                # distinct via the per-file occurrence counter
                occ = occurrence.get(row, 0)
                occurrence[row] = occ + 1
                key = ref_scalar("#iceberg", *row, occ)
            out.append((key, row, d))
        return out

    def _apply(self) -> list:
        meta = self.t.metadata()
        if not meta:
            return []
        sid = meta.get("current-snapshot-id", -1)
        if sid == -1 or sid == self._applied_snapshot:
            return []
        snap = self._snapshot_by_id(meta, sid)
        if snap is None:
            return []
        current = {
            fp for fp, status in self.t.snapshot_files(snap) if status != 2
        }
        events = []
        for fp in sorted(current - set(self._live_files)):
            rows = self._rows_of(fp)
            # rows are NOT cached: retraction on removal lazily re-reads the
            # parquet part (keeping every file's decoded rows would grow
            # memory with the whole table)
            self._live_files[fp] = None
            events.extend((0, k, r, d) for k, r, d in rows)
        for fp in sorted(set(self._live_files) - current):
            self._live_files.pop(fp)
            try:
                rows = self._rows_of(fp)
            except OSError:
                _log.warning(
                    "iceberg part %s already deleted; cannot retract its "
                    "rows", fp,
                )
                rows = []
            events.extend((0, k, r, -d) for k, r, d in rows)
        self._applied_snapshot = sid
        return events

    def static_events(self) -> list:
        if self.mode == "streaming":
            return []
        return self._apply()

    def poll(self):
        now = time.monotonic()
        if not self._first and now - self._last_poll < self.poll_interval_s:
            return []
        self._first = False
        self._last_poll = now
        try:
            events = self._apply()
            self._err = False
            return events
        except Exception as exc:
            self.n_failed_polls += 1
            if not self._err:
                _log.warning("iceberg poll failed: %s", exc)
                self._err = True
            return []


def read(catalog_uri_or_path: str, *, namespace=None,
         table_name: str | None = None, schema: SchemaMetaclass,
         mode: str = "streaming", autocommit_duration_ms: int = 500,
         poll_interval_s: float | None = None, **kwargs) -> Table:
    """Reference: pw.io.iceberg.read."""
    _check_entitlements("iceberg")
    path = catalog_uri_or_path
    if table_name:
        parts = list(namespace or []) + [table_name]
        path = os.path.join(path, *parts)
    if poll_interval_s is None:
        poll_interval_s = autocommit_duration_ms / 1000.0
    source = IcebergSource(path, schema, mode, poll_interval_s)
    return make_input_table(schema, source, name=f"iceberg:{path}", persistent_id=kwargs.get("persistent_id"))
