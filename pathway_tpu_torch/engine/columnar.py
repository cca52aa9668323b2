"""Struct-of-arrays update batches flowing BETWEEN operators.

The reference evaluates expressions batch-vectorized per AST node over
consolidated value batches (src/engine/dataflow.rs:1572-1604,
expression.rs:50,609).  Round 1 extracted columns from row tuples inside
each operator and rebuilt rows afterwards — O(rows x cols) Python work per
operator.  A ColumnarBatch instead carries the columns themselves from
operator to operator: a vectorized producer (select/filter/input) hands its
output columns directly to the consumer, which skips extraction entirely.

Compatibility contract: a ColumnarBatch behaves exactly like
`list[(key, row, diff)]` — iteration, len, indexing — so operators that
predate the columnar path work unchanged (rows materialize lazily, once,
via C-speed zip).  Columns are plain Python lists (value semantics stay
identical to the row engine: Python ints never silently become np.int64);
numpy views are built on demand and cached per column for the vector plans.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..internals.value import Error

# per-column magnitude bound enforced at extraction; see vectorize.py
_INT_LEAF_BOUND = 2**44


class ColumnarBatch:
    """Columns are plain Python lists OR numpy arrays (vector-plan outputs
    stay as arrays; row materialization `tolist()`s them, which yields
    native Python scalars, preserving value semantics)."""

    __slots__ = ("keys", "cols", "diffs", "_rows", "_np_cache")

    def __init__(self, keys: list, cols: list, diffs: list):
        self.keys = keys
        self.cols = cols
        self.diffs = diffs
        self._rows: list | None = None
        self._np_cache: dict[int, Any] = {}

    # -- list-of-updates compatibility -------------------------------------
    def list_col(self, ci: int) -> list:
        c = self.cols[ci]
        if isinstance(c, np.ndarray):
            c = c.tolist()
            self.cols[ci] = c
        return c

    def _materialize(self) -> list:
        if self._rows is None:
            lists = [self.list_col(i) for i in range(len(self.cols))]
            rows = list(zip(*lists)) if lists else [()] * len(self.keys)
            self._rows = list(zip(self.keys, rows, self.diffs))
        return self._rows

    def __iter__(self):
        return iter(self._materialize())

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, i):
        return self._materialize()[i]

    def __add__(self, other):
        return self._materialize() + list(other)

    def __radd__(self, other):
        return list(other) + self._materialize()

    # -- columnar access ----------------------------------------------------
    def np_col(self, ci: int):
        """Homogeneous numpy view of column ci, or None when the column mixes
        types / holds None/Error/unsupported values (same bail conditions as
        vectorize.try_columns).  Cached per batch."""
        if ci in self._np_cache:
            return self._np_cache[ci]
        c = self.cols[ci]
        arr = _validate_array(c) if isinstance(c, np.ndarray) else _np_from_list(c)
        self._np_cache[ci] = arr
        return arr

    def select_mask(self, mask: np.ndarray) -> "ColumnarBatch":
        idx = np.flatnonzero(mask)
        take = idx.tolist()
        keys = self.keys
        diffs = self.diffs
        cols_out = []
        child_cache: dict[int, Any] = {}
        for ci, c in enumerate(self.cols):
            cached = self._np_cache.get(ci)
            if cached is not None:
                # a validated column stays valid after slicing: the child
                # inherits the check instead of re-scanning 1M strings
                sliced = cached[idx]
                cols_out.append(sliced)
                child_cache[ci] = sliced
            elif isinstance(c, np.ndarray):
                cols_out.append(c[idx])
            else:
                cols_out.append([c[i] for i in take])
        out = ColumnarBatch(
            [keys[i] for i in take], cols_out, [diffs[i] for i in take]
        )
        out._np_cache.update(child_cache)
        return out

    def validated_ids(self) -> dict[int, Any]:
        """id(array) -> array for columns already validated on this batch
        (lets a producer mark passthrough outputs as pre-validated)."""
        return {
            id(arr): arr for arr in self._np_cache.values() if arr is not None
        }

    @staticmethod
    def from_updates(updates: list) -> "ColumnarBatch | None":
        """Transpose a row batch once (C-speed zip); None for ragged rows."""
        if isinstance(updates, ColumnarBatch):
            return updates
        if not updates:
            return None
        first_len = len(updates[0][1])
        keys = []
        rows = []
        diffs = []
        for key, row, diff in updates:
            if len(row) != first_len:
                return None
            keys.append(key)
            rows.append(row)
            diffs.append(diff)
        cols = [list(c) for c in zip(*rows)] if first_len else []
        return ColumnarBatch(keys, cols, diffs)


def _validate_array(arr: np.ndarray):
    """Re-admit an upstream plan's output array into the next plan: strings
    only for object dtype; int64 re-checked against the leaf bound (the
    overflow analysis assumes every input column is under it); bool/other
    dtypes take the row path."""
    if arr.ndim != 1:
        return None
    if arr.dtype == object:
        return None if any(not isinstance(v, str) for v in arr) else arr
    if arr.dtype == np.int64:
        if np.any(arr > _INT_LEAF_BOUND) or np.any(arr < -_INT_LEAF_BOUND):
            return None
        return arr
    if arr.dtype == np.float64:
        return arr
    return None


_INT_TYPES = frozenset({int, np.int64, np.int32})
_FLOAT_TYPES = frozenset({float, np.float64, np.float32})


def _np_from_list(values: list):
    """list -> homogeneous numpy array with the row-engine's type rules:
    int64 (magnitude-bounded), float64, or object-dtype strings.  None,
    Error, bool and mixed columns return None (row interpreter handles
    those; numpy bool arithmetic diverges from Python int semantics).

    Type detection is one C-speed pass — set(map(type, ...)) — instead of
    per-value isinstance chains; exact-type membership also keeps int
    subclasses (bool, Pointer) off the vector path by construction."""
    types = set(map(type, values))
    if not types:
        return None
    try:
        if types <= _INT_TYPES:
            arr = np.array(values, np.int64)
            if np.any(arr > _INT_LEAF_BOUND) or np.any(arr < -_INT_LEAF_BOUND):
                return None
            return arr
        if types <= _FLOAT_TYPES:
            return np.array(values, np.float64)
        if types == {str}:
            return np.array(values, object)
    except (TypeError, ValueError, OverflowError):
        return None
    return None
