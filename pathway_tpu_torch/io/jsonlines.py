"""JSONLines connector (reference: io/jsonlines + data_format/json).

The port of ``pathway_tpu/io/jsonlines.py``.
"""

from __future__ import annotations

import json

from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from ._utils import (
    FilePollingSource,
    JsonlinesWriter,
    StaticDataSource,
    add_output_node,
    events_from_dicts,
    make_input_table,
)


def _parse_jsonl_file(path: str) -> list[dict]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def read(
    path: str,
    *,
    schema: SchemaMetaclass,
    mode: str = "streaming",
    autocommit_duration_ms: int = 1500,
    json_field_paths: dict | None = None,
    **kwargs,
) -> Table:
    if mode in ("static", "batch"):
        import glob
        import os

        files = []
        if os.path.isdir(path):
            for root, _d, fs in os.walk(path):
                files.extend(os.path.join(root, f) for f in fs)
        else:
            files = sorted(glob.glob(path)) or [path]
        events = []
        for f in sorted(files):
            events.extend(events_from_dicts(_parse_jsonl_file(f), schema, seed=f))
        return make_input_table(schema, StaticDataSource(events),
                                name="jsonlines",
                                persistent_id=kwargs.get("persistent_id"))
    source = FilePollingSource(path, _parse_jsonl_file, schema)
    return make_input_table(schema, source, name="jsonlines",
                            persistent_id=kwargs.get("persistent_id"))


def write(table: Table, filename: str, **kwargs) -> None:
    add_output_node(table, JsonlinesWriter(filename))
