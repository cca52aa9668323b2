"""Change-stream <-> table converters (reference: internals/table.py
to_stream:?, stream_to_table, from_streams — the upsert-stream idiom).

The port of ``pathway_tpu/engine/stream_ops.py``.

`to_stream` nets each key's changes per logical time into ONE append-only
event row carrying an is-upsert flag; `stream_to_table` replays such events
(from one or many streams) back into keyed state.  Roundtrip preserves row
ids: events keep their source key.
"""

from __future__ import annotations

from typing import Any

from ..internals import dtype as dt
from ..internals import parse_graph as pg
from ..internals.value import ref_scalar
from .graph import Operator
from .types import Update, consolidate, rows_equal

#: to_stream carries the source row id here; stream_to_table keys on it
SOURCE_ID = "_pw_source_id"


class ToStreamOperator(Operator):
    """Per time, per key: inserts/replacements become one (row, True) event,
    bare deletions one (old row, False) event — emitted as inserts.

    Events get UNIQUE ids (derived from source key + time): the engine's
    table invariant is one live row per key, so a key changing at two
    times cannot reuse its id for both events.  The source key rides along
    as a pointer column, so stream_to_table can restore original ids."""

    def __init__(self, name: str = "to_stream"):
        super().__init__(name)
        self._buf: list[Update] = []

    def process(self, port, updates, time):
        self._buf.extend(updates)

    def flush(self, time):
        if not self._buf:
            return
        batch = consolidate(self._buf)
        self._buf = []
        by_key: dict[Any, tuple[list, list]] = {}
        for key, row, diff in batch:
            ins, dels = by_key.setdefault(key, ([], []))
            (ins if diff > 0 else dels).append(row)
        out = []
        for key, (ins, dels) in by_key.items():
            ekey = ref_scalar("to_stream", key, time)
            if ins:
                out.append((ekey, ins[-1] + (key, True), 1))
            elif dels:
                out.append((ekey, dels[-1] + (key, False), 1))
        if out:
            self.emit(time, out)


class StreamToTableOperator(Operator):
    """Replays upsert/delete events (any number of input streams, arrival
    order) into latest-value-per-key state.  State keys on the source-id
    column when one is present (to_stream output), else on the event id."""

    _STATE_ATTRS = ("rows",)

    def __init__(self, env, upsert_fn, drop_positions: tuple[int, ...],
                 source_id_pos: int | None, name: str = "stream_to_table"):
        super().__init__(name)
        self.env = env
        self.upsert_fn = upsert_fn
        # columns (flag / source id) removed from the output row
        self.drop_positions = tuple(sorted(drop_positions, reverse=True))
        self.source_id_pos = source_id_pos
        self.rows: dict[Any, tuple] = {}

    def _strip(self, row: tuple) -> tuple:
        for pos in self.drop_positions:
            row = row[:pos] + row[pos + 1:]
        return row

    def process(self, port, updates, time):
        out = []
        for key, row, diff in updates:
            if diff <= 0:
                continue  # streams are append-only; ignore malformed input
            is_upsert = bool(self.upsert_fn(self.env.build(key, row)))
            skey = (
                row[self.source_id_pos]
                if self.source_id_pos is not None else key
            )
            prev = self.rows.get(skey)
            if is_upsert:
                new = self._strip(row)
                if prev is not None:
                    if rows_equal(prev, new):
                        continue
                    out.append((skey, prev, -1))
                out.append((skey, new, 1))
                self.rows[skey] = new
            elif prev is not None:
                out.append((skey, prev, -1))
                del self.rows[skey]
        if out:
            self.emit(time, out)

    def state_size(self) -> int:
        return len(self.rows)


def install_table_methods() -> None:
    from ..internals.expression import ColumnReference
    from ..internals.table import Table, Universe

    def to_stream(self: Table, upsert_column_name: str = "is_upsert") -> Table:
        """Convert the table into an append-only stream of per-key change
        events with a boolean upsert flag (reference: Table.to_stream).
        Events carry fresh unique ids (the engine keeps one live row per
        id); the source row id rides in the `_pw_source_id` column so
        stream_to_table restores original ids."""
        node = pg.new_node("to_stream", [self])
        names = list(self._colnames) + [SOURCE_ID, upsert_column_name]
        dtypes = dict(self._dtypes)
        dtypes[SOURCE_ID] = dt.POINTER
        dtypes[upsert_column_name] = dt.BOOL
        out = Table(node, names, dtypes, Universe(), name="to_stream")
        out._append_only = True  # only diff>0 events, by construction
        return out

    def stream_to_table(self: Table, is_upsert) -> Table:
        """Replay a stream of upsert/delete events into a table
        (reference: Table.stream_to_table)."""
        return Table.from_streams(self, is_upsert=is_upsert)

    def from_streams(*streams: Table, is_upsert) -> Table:
        """Replay one or more change streams (same column layout) into a
        table (reference: Table.from_streams)."""
        if not streams:
            raise ValueError("from_streams needs at least one stream")
        first = streams[0]
        for s in streams[1:]:
            if list(s._colnames) != list(first._colnames):
                raise ValueError(
                    "from_streams requires identical column layouts, got "
                    f"{list(first._colnames)} vs {list(s._colnames)}"
                )
        expr = first._desugar(is_upsert)
        names = list(first._colnames)
        drop = []
        if isinstance(expr, ColumnReference) and expr.name in names:
            drop.append(names.index(expr.name))
        source_id_pos = (
            names.index(SOURCE_ID) if SOURCE_ID in names else None
        )
        if source_id_pos is not None:
            drop.append(source_id_pos)
        out_names = [n for i, n in enumerate(names) if i not in drop]
        dtypes = {n: first._dtype_of(n) for n in out_names}
        node = pg.new_node(
            "stream_to_table", list(streams), upsert_expr=expr,
            drop_positions=tuple(drop), source_id_pos=source_id_pos,
        )
        return Table(node, out_names, dtypes, Universe(),
                     name="stream_to_table")

    def unpack_snapshots(self: Table) -> Table:
        """Change stream -> snapshot stream: every changed minibatch emits
        the full table state as fresh rows (reference:
        Table.unpack_snapshots — beware output volume on large tables)."""
        node = pg.new_node("unpack_snapshots", [self])
        out = Table(node, list(self._colnames), dict(self._dtypes),
                    Universe(), name="unpack_snapshots")
        out._append_only = True
        return out

    def to(self: Table, sink) -> None:
        """Write the table to a sink (reference: Table.to(DataSink)).
        Accepts a callable sink (called with the table — the functional
        io.*.write idiom partially applied) or a writer object with a
        write_batch method (the engine's output-operator contract)."""
        if callable(sink) and not hasattr(sink, "write_batch"):
            sink(self)
            return
        if hasattr(sink, "write_batch"):
            pg.new_output_node(
                "output", [self], colnames=list(self._colnames), writer=sink
            )
            return
        raise TypeError(
            f"unsupported sink {sink!r}: expected a callable or an object "
            "with write_batch"
        )

    Table.to_stream = to_stream
    Table.stream_to_table = stream_to_table
    Table.from_streams = staticmethod(from_streams)
    Table.unpack_snapshots = unpack_snapshots
    Table.to = to


# lowerings
from .runner import _compile, _env_for, register_lowering  # noqa: E402


@register_lowering("to_stream")
def _lower_to_stream(node, lg):
    return ToStreamOperator()


@register_lowering("stream_to_table")
def _lower_stream_to_table(node, lg):
    p = node.params
    return StreamToTableOperator(
        _env_for(node.input_tables[0]),
        _compile(p["upsert_expr"]),
        p["drop_positions"],
        p["source_id_pos"],
    )


class UnpackSnapshotsOperator(Operator):
    """At every logical time that changes the table, emit the FULL state as
    fresh append-only rows (reference: Table.unpack_snapshots — snapshots
    accumulate; rows repeat per snapshot under unique event ids)."""

    _STATE_ATTRS = ("rows",)

    def __init__(self, name: str = "unpack_snapshots"):
        super().__init__(name)
        self.rows: dict[Any, tuple] = {}
        self._buf: list[Update] = []

    def process(self, port, updates, time):
        self._buf.extend(updates)

    def flush(self, time):
        if not self._buf:
            return
        batch = consolidate(self._buf)
        self._buf = []
        changed = False
        for key, row, diff in batch:
            if diff > 0:
                self.rows[key] = row
                changed = True
            elif self.rows.pop(key, None) is not None:
                changed = True
        if changed:
            self.emit(time, [
                (ref_scalar("snap", k, time), row, 1)
                for k, row in self.rows.items()
            ])


@register_lowering("unpack_snapshots")
def _lower_unpack_snapshots(node, lg):
    return UnpackSnapshotsOperator()
