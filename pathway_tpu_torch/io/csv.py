"""CSV connector (reference: io/csv + src/connectors/data_format/dsv).

The port of ``pathway_tpu/io/csv.py``.
"""

from __future__ import annotations

import csv as _csv
import dataclasses

from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from ._utils import (
    CsvWriter,
    FilePollingSource,
    StaticDataSource,
    add_output_node,
    events_from_dicts,
    make_input_table,
)


@dataclasses.dataclass
class CsvParserSettings:
    """Reference: pw.io.CsvParserSettings (dsv format options)."""

    delimiter: str = ","
    quote: str = '"'
    escape: str | None = None
    enable_double_quote_escapes: bool = True
    enable_quoting: bool = True
    comment_character: str | None = None


def _make_parse(csv_settings):
    if isinstance(csv_settings, dict):
        csv_settings = CsvParserSettings(**csv_settings)
    opts: dict = {}
    comment = None
    if csv_settings is not None:
        opts["delimiter"] = csv_settings.delimiter
        if csv_settings.enable_quoting:
            opts["quotechar"] = csv_settings.quote
            opts["doublequote"] = csv_settings.enable_double_quote_escapes
        else:
            opts["quoting"] = _csv.QUOTE_NONE
        if csv_settings.escape:
            opts["escapechar"] = csv_settings.escape
        comment = csv_settings.comment_character

    def parse(path: str) -> list[dict]:
        with open(path, newline="", encoding="utf-8") as f:
            if comment:
                # first-byte comment rule (matches the reference's csv
                # semantics); note: unsupported inside quoted multi-line
                # fields, as in the reference's line-oriented reader
                lines = (ln for ln in f if not ln.startswith(comment))
                return list(_csv.DictReader(lines, **opts))
            return list(_csv.DictReader(f, **opts))

    return parse


def read(
    path: str,
    *,
    schema: SchemaMetaclass,
    mode: str = "streaming",
    csv_settings: CsvParserSettings | dict | None = None,
    autocommit_duration_ms: int = 1500,
    with_metadata: bool = False,
    **kwargs,
) -> Table:
    parse = _make_parse(csv_settings)
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
            events.extend(events_from_dicts(parse(f), schema, seed=f))
        return make_input_table(schema, StaticDataSource(events), name="csv",
                                persistent_id=kwargs.get("persistent_id"))
    source = FilePollingSource(path, parse, schema)
    return make_input_table(schema, source, name="csv",
                            persistent_id=kwargs.get("persistent_id"))


def write(table: Table, filename: str, **kwargs) -> None:
    add_output_node(table, CsvWriter(filename))
