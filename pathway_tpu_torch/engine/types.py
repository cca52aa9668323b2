"""Engine data-plane types.

The engine's unit of data is an *update batch*: a list of
``(key, row, diff)`` triples at one logical time — a Z-set delta
(reference semantics: differential dataflow collections,
src/engine/dataflow.rs).  ``row`` is a tuple of column
values in the owning table's column order; ``diff`` is +1/-1 (other
integers may appear transiently and are consolidated away).

Dense numeric columns are encoded to numpy arrays / torch tensors only at the
boundary of vectorized operators (engine/vectorize.py) — host-side logic
stays columnar-agnostic.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator

Key = int
Row = tuple
Time = int

Update = tuple[Key, Row, int]  # (key, row, diff)


def consolidate(updates: Iterable[Update]) -> list[Update]:
    """Sum diffs per (key, row); drop zeros. Emits the original rows."""
    if not isinstance(updates, list):
        updates = list(updates)
    acc: dict[tuple[Key, Row], list] = {}
    try:
        # fast path: rows hashable (the overwhelmingly common case) — no
        # per-row probe-hash try/except, plain dict merge
        for key, row, diff in updates:
            k = (key, row)
            prev = acc.get(k)
            if prev is None:
                acc[k] = [row, diff]
            else:
                prev[1] += diff
    except TypeError:
        # a row held an unhashable value (np array, dict): redo with
        # wrapping — `updates` is a list, so restarting is safe
        acc = {}
        for key, row, diff in updates:
            k = (key, _hashable_row(row))
            prev = acc.get(k)
            if prev is None:
                acc[k] = [row, diff]
            else:
                prev[1] += diff
    out: list[Update] = []
    for (key, _hrow), (row, diff) in acc.items():
        if diff != 0:
            out.append((key, row, diff))
    return out


def _hashable_row(row: Row) -> Row:
    """Rows may contain unhashable values (np arrays, dicts) — wrap them."""
    try:
        hash(row)
        return row
    except TypeError:
        return tuple(_HashWrap(v) for v in row)


class _HashWrap:
    __slots__ = ("value", "_h")

    def __init__(self, value: Any):
        self.value = value
        from ..internals.value import hash_values

        self._h = hash_values(value)

    def __hash__(self) -> int:
        return self._h & 0x7FFFFFFFFFFFFFFF

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, _HashWrap):
            return self._h == other._h
        return False


def values_equal(a: Any, b: Any) -> bool:
    import numpy as np

    if a is b:
        return True
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if not (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)):
            return False
        return a.shape == b.shape and bool(np.array_equal(a, b))
    if type(a) is bool or type(b) is bool:
        return type(a) is type(b) and a == b
    try:
        return bool(a == b)
    except Exception:
        return False


def rows_equal(a: Row | None, b: Row | None) -> bool:
    if a is None or b is None:
        return a is b
    if len(a) != len(b):
        return False
    return all(values_equal(x, y) for x, y in zip(a, b))


def unwrap_row(row: Row) -> Row:
    if any(isinstance(v, _HashWrap) for v in row):
        return tuple(v.value if isinstance(v, _HashWrap) else v for v in row)
    return row


@dataclass
class StreamEntry:
    """One captured output event."""

    key: Key
    row: Row
    time: Time
    diff: int


class CapturedStream:
    """Accumulates output updates; supports squashing to a final table state.

    Mirrors the reference's CapturedStream + squash_updates
    (python/pathway/internals/api.py:197).
    """

    def __init__(self, column_names: list[str]):
        self.column_names = column_names
        self.entries: list[StreamEntry] = []

    def extend(self, time: Time, updates: Iterable[Update]) -> None:
        for key, row, diff in updates:
            self.entries.append(StreamEntry(key, unwrap_row(row), time, diff))

    def squash(self) -> dict[Key, Row]:
        """Final state: key -> row. Raises on inconsistent multiplicities."""
        state: dict[Key, tuple[Row, int]] = {}
        for e in sorted(self.entries, key=lambda e: e.time):
            if e.key in state:
                row, count = state[e.key]
                if count + e.diff == 0:
                    del state[e.key]
                else:
                    state[e.key] = (e.row, count + e.diff)
            else:
                if e.diff < 0:
                    raise ValueError(f"negative multiplicity for key {e.key}")
                state[e.key] = (e.row, e.diff)
        for key, (row, count) in state.items():
            if count != 1:
                raise ValueError(f"key {key} has multiplicity {count}")
        return {k: row for k, (row, _) in state.items()}

    def as_list(self) -> list[tuple[Key, Row, Time, int]]:
        return [(e.key, e.row, e.time, e.diff) for e in self.entries]
