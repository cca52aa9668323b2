"""Debug & test helpers (the port of ``pathway_tpu/debug``).

Reference: python/pathway/debug/__init__.py — table_from_markdown :446,
compute_and_print :222, compute_and_print_update_stream :250,
StreamGenerator :508.  The functions that run the graph take the data
plane's ``device`` (default ``"cuda"``: they raise without a card unless
``device="cpu"``).  ``table_from_parquet`` / ``table_to_parquet`` import
pandas (and its parquet engine) when called.
"""

from __future__ import annotations

import itertools
from typing import Any, Iterable, Mapping

from ..engine import runner as _runner
from ..internals import dtype as dt
from ..internals import parse_graph as pg
from ..internals.datasource import StaticDataSource, rows_to_events
from ..internals.schema import SchemaMetaclass, schema_from_types
from ..internals.table import Table, Universe
from ..internals.value import (
    Pointer,
    auto_row_keys,
    ref_scalar,
    ref_scalar_batch_rows,
)


def _batch_pk_keys(rows, pk_idx):
    """Primary-key keys through the native blake2b tier (bit-identical to
    per-row ref_scalar); None when a key column's type is outside the
    tier's (the caller keys per row)."""
    return ref_scalar_batch_rows(
        [[r[i] for i in pk_idx] for r in rows], len(pk_idx)
    )


__all__ = [
    "table_from_markdown",
    "table_from_rows",
    "table_from_pandas",
    "table_to_pandas",
    "table_to_dicts",
    "table_from_parquet",
    "table_to_parquet",
    "compute_and_print",
    "compute_and_print_update_stream",
    "StreamGenerator",
    "parse_to_table",
]


def _make_input_table(
    colnames: list[str],
    dtypes: dict[str, dt.DType],
    events,
    name: str = "input",
    append_only: bool = True,
) -> Table:
    source = StaticDataSource(events)
    node = pg.new_node("input", [], source=source)
    return Table(node, colnames, dtypes, Universe(), name=name)


def _parse_scalar(text: str):
    text = text.strip()
    if text in ("", "None"):
        return None
    if text == "True":
        return True
    if text == "False":
        return False
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    return text


def table_from_markdown(
    table_def: str,
    id_from: list[str] | None = None,
    unsafe_trusted_ids: bool = False,
    schema: SchemaMetaclass | None = None,
    _stream: bool = False,
) -> Table:
    """Build a static table from a markdown-ish fixed-width definition.

    Supports the reference's special columns: a leading unnamed/`id` column for
    explicit row ids, `__time__` and `__diff__` for simulated streams.
    """
    lines = [ln for ln in table_def.strip().splitlines() if ln.strip()]
    lines = [ln for ln in lines if not set(ln.strip()) <= set("|-+ :")]
    header, *rows_txt = lines

    def split(ln: str) -> list[str]:
        if "|" in ln:
            parts = [p.strip() for p in ln.split("|")]
            if parts and parts[0] == "":
                parts = parts[1:]
            return parts
        return ln.split()

    colnames = split(header)
    while colnames and colnames[-1] == "":
        colnames = colnames[:-1]
    has_id = False
    if colnames and colnames[0] in ("id", ""):
        has_id = True
        colnames = colnames[1:]

    special = {"__time__", "__diff__"}
    data_cols = [c for c in colnames if c not in special]

    events = []
    auto_id = itertools.count()
    parsed_rows = []
    for ln in rows_txt:
        parts = split(ln)
        # a trailing pipe leaves one extra empty cell
        if len(parts) > len(colnames) + 1 and parts[-1] == "":
            parts = parts[:-1]
        parsed_rows.append(parts)
    # id-column detection is per TABLE and must be consistent: every row
    # carries exactly one extra leading field (a single malformed row must
    # raise, not silently flip the interpretation)
    if not has_id and parsed_rows:
        has_id = all(len(p) == len(colnames) + 1 for p in parsed_rows) and any(
            p[-1] != "" for p in parsed_rows
        )
    for ln, parts in zip(rows_txt, parsed_rows):
        if has_id:
            if len(parts) != len(colnames) + 1:
                raise ValueError(
                    f"row {ln!r} has {len(parts)} fields, expected "
                    f"{len(colnames) + 1} (id + columns)"
                )
            rid = parts[0]
            parts = parts[1:]
        else:
            rid = None
            if len(parts) == len(colnames) + 1 and parts[-1] == "":
                parts = parts[:-1]
            if len(parts) != len(colnames):
                raise ValueError(
                    f"row {ln!r} has {len(parts)} fields, expected {len(colnames)}"
                )
        values = dict(zip(colnames, [_parse_scalar(p) for p in parts]))
        t = int(values.pop("__time__", 0))
        diff = int(values.pop("__diff__", 1))
        row = tuple(values[c] for c in data_cols)
        if rid is not None:
            key = ref_scalar(rid)
        elif id_from:
            key = ref_scalar(*[values[c] for c in id_from])
        else:
            key = ref_scalar("#row", next(auto_id))
        events.append((t, key, row, diff))

    if schema is not None:
        dtypes = dict(schema.dtypes())
    else:
        dtypes = {}
        for i, c in enumerate(data_cols):
            vals = [e[2][i] for e in events if e[2][i] is not None]
            dtypes[c] = dt.lub(*[dt.dtype_of_value(v) for v in vals]) if vals else dt.ANY
            if any(e[2][i] is None for e in events):
                dtypes[c] = dt.optional(dtypes[c])
    events.sort(key=lambda e: e[0])
    return _make_input_table(data_cols, dtypes, events, name="markdown")


parse_to_table = table_from_markdown


def table_from_rows(
    schema: SchemaMetaclass,
    rows: Iterable[tuple],
    is_stream: bool = False,
) -> Table:
    colnames = schema.column_names()
    pk = schema.primary_key_columns()
    if not is_stream:
        # columnar ingest: transpose once, batch-hash auto keys, feed the
        # engine a struct-of-arrays batch (no per-row event tuples)
        rows = [tuple(r) for r in rows]
        n = len(rows)
        if pk:
            pk_idx = [colnames.index(c) for c in pk]
            keys = _batch_pk_keys(rows, pk_idx)
            if keys is None:
                keys = [ref_scalar(*[r[i] for i in pk_idx]) for r in rows]
        else:
            # same auto-key scheme as the event path below and markdown
            # tables, so static/streamed tables over the same ordinal rows
            # keep identical universes
            keys = auto_row_keys(n)
        from ..engine.columnar import ColumnarBatch
        from ..internals.datasource import ColumnarStaticSource

        cols = [list(c) for c in zip(*rows)] if rows else [[] for _ in colnames]
        batch = ColumnarBatch(keys, cols, [1] * n)
        source = ColumnarStaticSource([(0, batch)])
        node = pg.new_node("input", [], source=source)
        return Table(node, colnames, dict(schema.dtypes()), Universe(), name="rows")
    events = []
    auto = itertools.count()
    for r in rows:
        r = tuple(r)
        *vals, t, diff = r
        if pk:
            key = ref_scalar(*[vals[colnames.index(c)] for c in pk])
        else:
            key = ref_scalar("#row", next(auto))
        events.append((t, key, tuple(vals), diff))
    events.sort(key=lambda e: e[0])
    return _make_input_table(colnames, dict(schema.dtypes()), events)


def table_from_pandas(df, id_from: list[str] | None = None, schema=None) -> Table:
    from ..internals.schema import schema_from_pandas

    sch = schema or schema_from_pandas(df, id_from=id_from)
    colnames = sch.column_names()
    events = []
    use_index_keys = df.index.name is None and not id_from
    for i, (idx, row) in enumerate(df.iterrows()):
        vals = tuple(_from_pandas_value(row[c]) for c in colnames)
        if id_from:
            key = ref_scalar(*[row[c] for c in id_from])
        else:
            key = ref_scalar("#pd", idx if not use_index_keys else i)
        events.append((0, key, vals, 1))
    return _make_input_table(colnames, dict(sch.dtypes()), events, name="pandas")


def _from_pandas_value(v):
    import numpy as np
    import pandas as pd

    if isinstance(v, np.generic):
        v = v.item()
    if v is pd.NaT:
        return None
    if isinstance(v, float) and pd.isna(v):
        return None
    if isinstance(v, pd.Timestamp):
        return v.to_pydatetime()
    return v


def _captured_to_rows(cap) -> list[tuple[Pointer, tuple]]:
    state = cap.squash()
    return sorted(state.items(), key=lambda kv: kv[0])


def table_to_dicts(table: Table, *, device="cuda"):
    [cap] = _runner.run_tables(table, device=device)
    state = cap.squash()
    keys = list(state.keys())
    columns = {
        name: {k: state[k][i] for k in keys}
        for i, name in enumerate(cap.column_names)
    }
    return keys, columns


def table_from_parquet(path, id_from: list[str] | None = None,
                       schema=None) -> Table:
    """Static table from a parquet file (reference: debug/table_from_parquet)."""
    import pandas as pd

    return table_from_pandas(pd.read_parquet(path), id_from=id_from,
                             schema=schema)


def table_to_parquet(table: Table, filename, *, device="cuda") -> None:
    """Run the graph and write the table's final state to parquet
    (reference: debug/table_to_parquet)."""
    df = table_to_pandas(table, include_id=False, device=device)
    df.to_parquet(filename)


def table_to_pandas(table: Table, include_id: bool = True, *, device="cuda"):
    import pandas as pd

    [cap] = _runner.run_tables(table, device=device)
    state = cap.squash()
    keys = sorted(state.keys())
    data = {name: [state[k][i] for k in keys] for i, name in enumerate(cap.column_names)}
    if include_id:
        return pd.DataFrame(data, index=keys)
    return pd.DataFrame(data)


def _fmt_val(v) -> str:
    if isinstance(v, str):
        return v
    return repr(v) if not isinstance(v, (int, float, bool, type(None))) else str(v)


def compute_and_print(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    squash_updates: bool = True,
    terminate_on_error: bool = True,
    device="cuda",
) -> None:
    [cap] = _runner.run_tables(table, terminate_on_error=terminate_on_error,
                               device=device)
    state = cap.squash()
    keys = sorted(state.keys())
    if n_rows is not None:
        keys = keys[:n_rows]
    cols = cap.column_names
    header = ([""] if include_id else []) + cols
    rows = []
    for k in keys:
        r = state[k]
        rows.append(
            ([f"^{int(k):X}"[:8] if short_pointers else str(k)] if include_id else [])
            + [_fmt_val(v) for v in r]
        )
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h) for i, h in enumerate(header)]
    print(" | ".join(h.ljust(w) for h, w in zip(header, widths)).rstrip())
    for r in rows:
        print(" | ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())


def compute_and_print_update_stream(table: Table, *, device="cuda",
                                    **kwargs) -> None:
    [cap] = _runner.run_tables(table, device=device)
    cols = cap.column_names + ["__time__", "__diff__"]
    print(" | ".join(cols))
    for e in sorted(cap.entries, key=lambda e: (e.time, -e.diff)):
        print(" | ".join([_fmt_val(v) for v in e.row] + [str(e.time), str(e.diff)]))


class StreamGenerator:
    """Deterministic simulated streams (reference: debug/__init__.py:508)."""

    def __init__(self):
        self._time = itertools.count(2, 2)

    def table_from_list_of_batches_by_workers(self, batches, schema):
        rows = []
        for batch in batches:
            t = next(self._time)
            for worker_rows in batch.values():
                for r in worker_rows:
                    rows.append(tuple(r[c] for c in schema.column_names()) + (t, 1))
        return table_from_rows(schema, rows, is_stream=True)

    def table_from_list_of_batches(self, batches, schema):
        return self.table_from_list_of_batches_by_workers(
            [{0: batch} for batch in batches], schema
        )
