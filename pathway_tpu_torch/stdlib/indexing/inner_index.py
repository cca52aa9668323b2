"""Dense exact KNN index with its matrix held on the device.

Counterpart of ``pathway_tpu/stdlib/indexing/inner_index.py``
``BruteForceKnn``: ``add``/``remove`` keep one dense (capacity, d) f32
matrix on the index's device, and every batched search is one scores
launch (the CUDA kernel on the card) plus ``torch.topk``
(``ops/knn_cuda.py``).  Only the (Q, k) results come back to the host.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..._device import resolve_device
from ...ops.knn import METRICS
from ...ops.knn_cuda import knn_topk


class BruteForceKnn:
    def __init__(self, dimensions: int | None = None, *,
                 reserved_space: int = 1024, metric: str = "cos",
                 device="cuda"):
        if metric not in METRICS:
            raise ValueError(f"unknown metric {metric!r}; expected {METRICS}")
        self.device = resolve_device(device)
        self.dim = dimensions
        self.metric = metric
        self.capacity = max(reserved_space, 16)
        self.matrix: torch.Tensor | None = None
        self.keys: list[int] = []
        self.slot_of: dict[int, int] = {}
        self.metadata: dict[int, Any] = {}
        self.n = 0

    def _ensure(self, dim: int) -> None:
        if self.matrix is None:
            self.dim = dim
            self.matrix = torch.zeros((self.capacity, dim),
                                      dtype=torch.float32, device=self.device)

    def _grow_if_full(self) -> None:
        if self.n == self.capacity:
            self.capacity *= 2
            new = torch.zeros((self.capacity, self.dim), dtype=torch.float32,
                              device=self.device)
            new[: self.n] = self.matrix[: self.n]
            self.matrix = new

    def add(self, key: int, item: Any, metadata: Any = None) -> None:
        """Insert or replace ``key``'s vector (a tensor, on any device, or
        an array-like)."""
        vec = torch.as_tensor(
            item if isinstance(item, torch.Tensor)
            else np.asarray(item, np.float32)
        ).reshape(-1)
        self._ensure(vec.shape[0])
        if vec.shape[0] != self.dim:
            raise ValueError(f"vector dim {vec.shape[0]} != index dim {self.dim}")
        slot = self.slot_of.get(key)
        if slot is None:
            self._grow_if_full()
            slot = self.n
            self.slot_of[key] = slot
            self.keys.append(key)
            self.n += 1
        self.matrix[slot] = vec.to(device=self.device, dtype=torch.float32)
        self.metadata[key] = metadata

    def remove(self, key: int) -> None:
        """Drop ``key``; the last row moves into its slot."""
        slot = self.slot_of.pop(key, None)
        if slot is None:
            return
        last = self.n - 1
        if slot != last:
            last_key = self.keys[last]
            self.matrix[slot] = self.matrix[last]
            self.keys[slot] = last_key
            self.slot_of[last_key] = slot
        self.keys.pop()
        self.metadata.pop(key, None)
        self.n = last

    def search_batch(self, queries, k: int) -> list[list[tuple[int, float]]]:
        """Top-``k`` ``(key, score)`` per query, higher score = better: one
        scores launch for the whole batch."""
        if self.n == 0:
            return [[] for _ in queries]
        if isinstance(queries, torch.Tensor):
            qs = queries.reshape(len(queries), -1)
        else:
            qs = np.asarray(
                [np.asarray(q, np.float32).reshape(-1) for q in queries]
            )
        vals, idx = knn_topk(self.matrix[: self.n], qs, k, self.metric,
                             device=self.device)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        return [
            [(self.keys[int(i)], float(v)) for v, i in zip(vi, ii)]
            for vi, ii in zip(vals, idx)
        ]
