"""Filesystem connector: ``binary``, ``plaintext`` and
``plaintext_by_file`` formats with metadata, and ``csv`` / ``json``
through ``io.csv`` / ``io.jsonlines`` (the port of
``pathway_tpu/io/fs.py``; reference: io/fs +
src/connectors/scanner/filesystem.rs).

``mode="static"`` reads what is there once; ``mode="streaming"`` polls
the path and emits new files and new lines, retracting the rows of a
deleted file.  Under persistence a streamed file's bytes go to the object
cache, and a file that vanished is parsed from there with the metadata
captured when it was cached (``cached_metadata``).  ``persistent_id=``
names the source for ``selective_persisting``.
"""

from __future__ import annotations

import glob
import os

from ..internals import dtype as dt
from ..internals.datasource import StaticDataSource
from ..internals.schema import (ColumnDefinition, SchemaMetaclass,
                                schema_from_columns)
from ..internals.table import Table
from ..internals.value import Json
from . import csv as _csv_mod
from . import jsonlines as _jsonl_mod
from ._utils import FilePollingSource, events_from_dicts, make_input_table


def _schema(data_dtype, with_metadata: bool) -> SchemaMetaclass:
    cols = {"data": ColumnDefinition(dtype=data_dtype)}
    if with_metadata:
        cols["_metadata"] = ColumnDefinition(dtype=dt.JSON)
    return schema_from_columns(cols, name="FsSchema")


def _metadata_for(path: str) -> Json:
    st = os.stat(path)
    return Json({
        "path": os.path.abspath(path),
        "name": os.path.basename(path),
        "size": st.st_size,
        "modified_at": int(st.st_mtime),
        "created_at": int(st.st_ctime),
        "seen_at": int(st.st_mtime),
    })


def read(
    path: str,
    *,
    format: str = "binary",  # noqa: A002
    schema: SchemaMetaclass | None = None,
    mode: str = "streaming",
    with_metadata: bool = False,
    autocommit_duration_ms: int = 1500,
    **kwargs,
) -> Table:
    if format == "csv":
        return _csv_mod.read(path, schema=schema, mode=mode, **kwargs)
    if format == "json":
        return _jsonl_mod.read(path, schema=schema, mode=mode, **kwargs)
    if format not in ("plaintext", "plaintext_by_file", "binary"):
        raise ValueError(f"unknown format {format!r}")
    binary = format == "binary"
    by_file = format in ("binary", "plaintext_by_file")
    sch = schema or _schema(dt.BYTES if binary else dt.STR, with_metadata)

    def parse_file(p: str, data: bytes | None = None,
                   cached_metadata: Json | None = None) -> list[dict]:
        # data: the bytes already read (the object cache stores the same);
        # cached_metadata: a vanished file's metadata, from the cache
        meta = None
        if with_metadata:
            meta = _metadata_for(p) if os.path.exists(p) else cached_metadata
        if binary:
            if data is None:
                with open(p, "rb") as f:
                    data = f.read()
            rows = [{"data": data}]
        else:
            if data is not None:
                text = data.decode("utf-8", errors="replace")
            else:
                with open(p, encoding="utf-8", errors="replace") as f:
                    text = f.read()
            rows = ([{"data": text}] if by_file else
                    [{"data": line.rstrip("\n")} for line in text.splitlines()])
        if with_metadata:
            for r in rows:
                r["_metadata"] = meta
        return rows

    if mode in ("static", "batch"):
        if os.path.isdir(path):
            files = [os.path.join(root, f)
                     for root, _d, fs in os.walk(path) for f in fs]
        else:
            files = glob.glob(path) or ([path] if os.path.exists(path) else [])
        events = []
        for f in sorted(files):
            events.extend(events_from_dicts(parse_file(f), sch, seed=f))
        return make_input_table(sch, StaticDataSource(events), name="fs",
                                persistent_id=kwargs.get("persistent_id"))
    if mode != "streaming":
        raise ValueError(f"unknown mode {mode!r}")
    source = FilePollingSource(path, parse_file, sch)
    if with_metadata:
        source.cache_metadata_fn = _metadata_for
    return make_input_table(sch, source, name="fs",
                            persistent_id=kwargs.get("persistent_id"))


def write(table: Table, filename: str, format: str = "json", **kwargs) -> None:  # noqa: A002
    if format in ("json", "jsonlines"):
        _jsonl_mod.write(table, filename)
    elif format == "csv":
        _csv_mod.write(table, filename)
    else:
        raise ValueError(f"unknown format {format!r}")


__all__ = ["read", "write"]
