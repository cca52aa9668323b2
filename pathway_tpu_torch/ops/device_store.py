"""Device-resident embedding store: vectors stay on the device from the
encoder's forward pass to the index's score product, and never cross to
the host.

Counterpart of ``pathway_tpu/ops/device_store.py``.  ``DeviceVecStore``
takes the encoder's output batches (each a (B, d) tensor on the device)
without synchronising: ``append_batch`` writes each batch into a
preallocated buffer by slice assignment, which PyTorch queues on the
current stream, and returns one ``DeviceVec`` handle per row.  The
handle flows through an index (or a dataflow) as an ordinary value;
the KNN index consolidates the rows it holds into one (N, d) matrix
with a single ``index_select`` (``gather``).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .._device import resolve_device

_store_ids = itertools.count()


class DeviceVecStore:
    """Append-only pool of device-resident embedding rows.

    Rows live in ``(BUF_ROWS, d)`` f32 buffers on the device; a batch
    that does not fit the current buffer starts the next one (the gap is
    never referenced), so a row's handle is (buffer, row) for the life
    of the store.  The buffers are consecutive ``BUF_ROWS``-row slices of
    one allocation, which doubles (one device copy) when a new buffer
    does not fit: the buffers' concatenation is that allocation itself,
    so ``gather`` is one ``index_select`` and never concatenates."""

    BUF_ROWS = 8192

    def __init__(self, dimensions: int | None = None, *, device="cuda"):
        self.device = resolve_device(device)
        self.id = next(_store_ids)
        self.dim = dimensions
        self._arena: torch.Tensor | None = None  # (n * BUF_ROWS, d) f32
        self._n_bufs = 0                         # buffers started
        self._fill = 0                           # rows used in the LAST one

    def _buffer(self, b: int) -> torch.Tensor:
        return self._arena[b * self.BUF_ROWS:(b + 1) * self.BUF_ROWS]

    def _ensure_space(self, n: int) -> None:
        if self._n_bufs and self._fill + n <= self.BUF_ROWS:
            return
        if self._arena is None or (self._arena.shape[0]
                                   < (self._n_bufs + 1) * self.BUF_ROWS):
            grown = torch.zeros((max(1, 2 * self._n_bufs) * self.BUF_ROWS,
                                 self.dim),
                                dtype=torch.float32, device=self.device)
            if self._arena is not None:
                grown[: self._arena.shape[0]] = self._arena
            self._arena = grown
        self._n_bufs += 1
        self._fill = 0

    def append_batch(self, t: torch.Tensor,
                     n_valid: int | None = None) -> list["DeviceVec"]:
        """Register one encoder output batch and return a handle per valid
        row.  Queues one copy on the current stream: no sync, no fetch."""
        if self.dim is None:
            self.dim = int(t.shape[1])
        n_rows = int(t.shape[0])
        n = n_rows if n_valid is None else n_valid
        if n_rows > self.BUF_ROWS:
            raise ValueError(
                f"batch of {n_rows} rows exceeds DeviceVecStore buffer "
                f"capacity {self.BUF_ROWS}"
            )
        if t.device.type != self.device.type:
            raise ValueError(f"batch on {t.device}, store on {self.device}")
        self._ensure_space(n_rows)
        bid = self._n_bufs - 1
        start = self._fill
        self._buffer(bid)[start:start + n_rows] = t
        self._fill += n_rows
        return [DeviceVec(self, bid, start + r) for r in range(n)]

    def n_batches(self) -> int:
        """Buffers started so far."""
        return self._n_bufs

    def gather(self, refs: list[tuple[int, int]],
               pad_to: int | None = None) -> torch.Tensor:
        """One (N, d) tensor on the device holding the given (buffer, row)
        refs, in order, from a single ``index_select``.  ``pad_to`` pads
        the output to a bucketed row count (padding rows repeat buffer
        row 0; consumers mask them by ``n_valid``); on an empty store it
        is a zero fill, and ``pad_to=0`` asks for zero rows."""
        if not refs and (pad_to is None or not self._n_bufs):
            return torch.zeros((pad_to or 0, self.dim or 0),
                               dtype=torch.float32, device=self.device)
        flat = np.fromiter((bid * self.BUF_ROWS + row for bid, row in refs),
                           dtype=np.int64, count=len(refs))
        if pad_to is not None and pad_to > len(refs):
            flat = np.concatenate(
                [flat, np.zeros(pad_to - len(refs), np.int64)])
        idx = torch.from_numpy(flat).to(self.device, non_blocking=True)
        return self._arena.index_select(0, idx)

    def row(self, batch: int, r: int) -> np.ndarray:
        """Host copy of one row (the slow path: serving and ingest never
        call it; pickling and array consumers do)."""
        return self._buffer(batch)[r].to("cpu", copy=True).numpy()


class DeviceVec:
    """Handle to one device-resident embedding row.

    Behaves as a value: equality and hash follow the (store, batch, row)
    identity, stable for the life of the store; ``__array__`` and
    ``to_numpy`` copy the row to the host; pickling carries the numbers
    (a numpy array), not the handle."""

    __slots__ = ("store", "batch", "row_idx")

    def __init__(self, store: DeviceVecStore, batch: int, row_idx: int):
        self.store = store
        self.batch = batch
        self.row_idx = row_idx

    def __eq__(self, other):
        if isinstance(other, DeviceVec):
            return (self.store.id, self.batch, self.row_idx) == (
                other.store.id, other.batch, other.row_idx
            )
        return NotImplemented

    def __hash__(self):
        return hash(("DeviceVec", self.store.id, self.batch, self.row_idx))

    def __repr__(self):
        return (f"DeviceVec(store={self.store.id}, batch={self.batch}, "
                f"row={self.row_idx})")

    def __array__(self, dtype=None, copy=None):
        arr = self.store.row(self.batch, self.row_idx)
        return arr.astype(dtype) if dtype is not None else arr

    def to_numpy(self) -> np.ndarray:
        return self.store.row(self.batch, self.row_idx)

    def __reduce__(self):
        return (np.asarray, (self.to_numpy(),))
