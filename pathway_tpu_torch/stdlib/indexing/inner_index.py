"""Mutable secondary indexes behind ``DataIndex``: ``add`` / ``remove`` /
``search`` (the JAX package's ``InnerIndex``).

Counterpart of ``pathway_tpu/stdlib/indexing/inner_index.py``: the dense
exact KNN index ``BruteForceKnn`` (and ``USearchKnn``, its alias), with
its matrix held on the device; the approximate tiers ``IvfKnn`` (a
k-means coarse quantizer over a cluster-major matrix) and ``LshKnn``
(random-hyperplane buckets), host numpy in both packages with the same
seeded draws, so their keys and scores equal the JAX indexes'; and the
host-side full-text indexes the RAG templates use, ``TantivyBM25``
(Okapi BM25 over an inverted index) and ``HybridIndex`` (reciprocal-rank
fusion over sub-indexes), which are Python on the host in both
packages.

``BruteForceKnn``'s rows come in two kinds, as in the JAX index:

- host rows (a tensor or an array-like), written into one dense
  (capacity, d) f32 matrix on the index's device;
- device-resident rows, ``DeviceVec`` handles into a ``DeviceVecStore``
  (``ops/device_store.py``): ``add`` records the (store, buffer, row)
  reference and copies nothing.

``_device_matrix`` consolidates every live row into one bucket-padded
(power of two, at least 256 rows) matrix on the device, once per index
version: one ``index_select`` when every row comes from one store,
otherwise the host rows plus one gather-and-scatter per store.  For
``cos`` it is L2-normalised once there, so a query is one scores launch
against it (the CUDA kernel on the card: GEMV for one query, GEMM for a
batch of 16 or more) plus a top-k in ``lax.top_k``'s order; only the
(k,) or (Q, k) results come back to the host.

``search(tier="cpu")`` scores a host mirror in numpy (f16 when rows are
device-resident), as the JAX index's CPU tier does.  Every other search,
at any index size, scores the device matrix; a metadata-filtered one
fetches the full score vector and walks it in order until ``k`` rows
pass the filter.

With a ``mesh`` (``parallel/mesh.TPMesh``), an unfiltered search over
host rows (``n >= k``) scores the matrix split by rows over the mesh's
shards (``ops/knn_sharded.py``: per-shard top-k, then one merge), the
shards cached until the next mutation.  (The JAX index scores a small host-row index in
numpy, because its rows live there; the port's rows live on the device.)
"""

from __future__ import annotations

import math
import re
import time as _time
from collections import Counter, defaultdict
from typing import Any

import numpy as np
import torch

from ..._device import resolve_device
from ...obs.tracer import record_span
from ...ops.device_store import DeviceVec
from ...ops.knn import METRICS, batched_topk, device_topk, device_topk_scores


class InnerIndex:
    def add(self, key: int, item: Any, metadata: Any = None) -> None:
        raise NotImplementedError

    def remove(self, key: int) -> None:
        raise NotImplementedError

    def search(self, query: Any, k: int, metadata_filter: str | None = None
               ) -> list[tuple[int, float]]:
        """Returns [(key, score)] with higher score = better."""
        raise NotImplementedError


def _check_metadata(metadata, metadata_filter: str | None) -> bool:
    if metadata_filter is None:
        return True
    from .jmespath_filter import evaluate_filter

    return evaluate_filter(metadata_filter, metadata)


def _host_vec(x) -> np.ndarray:
    """One vector as a flat f32 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32)
    return np.asarray(x, dtype=np.float32).reshape(-1)


class BruteForceKnn(InnerIndex):
    def __init__(self, dimensions: int | None = None, *,
                 reserved_space: int = 1024, metric: str = "cos",
                 device="cuda", mesh=None, mesh_axis: str | None = None):
        if metric not in METRICS:
            raise ValueError(f"unknown metric {metric!r}; expected {METRICS}")
        self.device = resolve_device(device)
        self.dim = dimensions
        self.metric = metric
        self.capacity = max(reserved_space, 16)
        self.matrix: torch.Tensor | None = None  # host rows, on the device
        self.keys: list[int] = []
        self.slot_of: dict[int, int] = {}
        self.metadata: dict[int, Any] = {}
        self.n = 0
        # slot -> (store, batch, row) of a device-resident row
        self._dev_refs: dict[int, tuple] = {}
        self._version = 0
        self._dev_matrix = None        # ((version, prenorm), (bucket, d))
        self._dev_valid = 0            # live rows in the device matrix
        self._host_mirror = None       # (version, np (n, d))
        self._host_mirror_norm = None  # (version, L2-normed mirror)
        # row-sharded search (ops/knn_sharded.py): the mesh, its axis
        # (default: the mesh's one axis) and ((version, bucket), shards)
        self.mesh = mesh
        self.mesh_axis = (mesh_axis if mesh_axis is not None or mesh is None
                          else mesh.axis_name)
        self._mesh_matrix = None

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

    def _invalidate(self) -> None:
        self._dev_matrix = None
        self._mesh_matrix = None
        self._host_mirror = None
        self._host_mirror_norm = None
        self._version += 1

    def _slot(self, key: int, metadata: Any) -> int:
        """``key``'s slot, a new one at the end for a new key."""
        slot = self.slot_of.get(key)
        if slot is None:
            self._grow_if_full()
            slot = self.n
            self.slot_of[key] = slot
            self.keys.append(key)
            self.n += 1
        self.metadata[key] = metadata
        return slot

    def add(self, key: int, item: Any, metadata: Any = None) -> None:
        """Insert or replace ``key``'s vector: a ``DeviceVec`` (its
        reference is recorded, nothing is copied), a tensor on any device,
        or an array-like."""
        if isinstance(item, DeviceVec):
            if item.store.device.type != self.device.type:
                raise ValueError(f"DeviceVec on {item.store.device}, index "
                                 f"on {self.device}")
            self._ensure(item.store.dim)
            slot = self._slot(key, metadata)
            self._dev_refs[slot] = (item.store, item.batch, item.row_idx)
        else:
            vec = (item.detach() if isinstance(item, torch.Tensor)
                   else torch.from_numpy(np.asarray(item, np.float32)))
            vec = vec.reshape(-1)
            self._ensure(vec.shape[0])
            if vec.shape[0] != self.dim:
                raise ValueError(
                    f"vector dim {vec.shape[0]} != index dim {self.dim}")
            slot = self._slot(key, metadata)
            self.matrix[slot] = vec.to(device=self.device, dtype=torch.float32)
            self._dev_refs.pop(slot, None)
        self._invalidate()

    def add_batch(self, keys: list, items: list, metadata: list) -> None:
        """``add`` of many rows: host rows (array-likes, tensors) are
        stacked and copied to the device in one transfer (an operator
        snapshot's restore rebuilds the index so); ``DeviceVec`` rows
        record their reference, as ``add`` does."""
        host = [i for i, it in enumerate(items)
                if not isinstance(it, DeviceVec)]
        for i, it in enumerate(items):
            if isinstance(it, DeviceVec):
                self.add(keys[i], it, metadata[i])
        if not host:
            return
        rows = np.stack([_host_vec(items[i]) for i in host])
        self._ensure(rows.shape[1])
        if rows.shape[1] != self.dim:
            raise ValueError(
                f"vector dim {rows.shape[1]} != index dim {self.dim}")
        slots = [self._slot(keys[i], metadata[i]) for i in host]
        for slot in slots:
            self._dev_refs.pop(slot, None)
        self.matrix[torch.tensor(slots, dtype=torch.int64,
                                 device=self.device)] = (
            torch.from_numpy(rows).to(self.device))
        self._invalidate()

    def remove(self, key: int) -> None:
        """Drop ``key``; the last row (and its device reference) moves
        into its slot."""
        slot = self.slot_of.pop(key, None)
        if slot is None:
            return
        last = self.n - 1
        last_key = self.keys[last]
        if slot != last:
            self.matrix[slot] = self.matrix[last]
            last_ref = self._dev_refs.pop(last, None)
            if last_ref is not None:
                self._dev_refs[slot] = last_ref
            else:
                self._dev_refs.pop(slot, None)
            self.keys[slot] = last_key
            self.slot_of[last_key] = slot
        else:
            self._dev_refs.pop(slot, None)
        self.keys.pop()
        self.metadata.pop(key, None)
        self.n = last
        self._invalidate()

    # -- consolidation -----------------------------------------------------
    @staticmethod
    def _bucket_rows(n: int) -> int:
        """Next power-of-two row bucket (at least 256): the consolidated
        matrix keeps its shape while the index grows within a bucket."""
        b = 256
        while b < n:
            b *= 2
        return b

    def _device_matrix(self, prenorm: bool) -> torch.Tensor:
        """One (bucket, d) matrix on the device over all live slots (rows
        past ``self._dev_valid`` are padding), L2-normalised when
        ``prenorm``.  Cached until the next mutation."""
        token = (self._version, prenorm)
        if self._dev_matrix is not None and self._dev_matrix[0] == token:
            return self._dev_matrix[1]
        self._dev_valid = n = self.n
        bucket = self._bucket_rows(n)
        stores = {ref[0].id for ref in self._dev_refs.values()}
        if len(stores) == 1 and len(self._dev_refs) == n and n > 0:
            store = next(iter(self._dev_refs.values()))[0]
            refs = [(self._dev_refs[s][1], self._dev_refs[s][2])
                    for s in range(n)]
            m = store.gather(refs, pad_to=bucket)
        else:
            # host rows, mixed, or several stores: the host rows, then
            # one gather-and-scatter per DeviceVecStore
            m = torch.zeros((bucket, self.dim), dtype=torch.float32,
                            device=self.device)
            m[:n] = self.matrix[:n]
            by_store: dict[int, tuple] = {}
            for s, (store, b, r) in self._dev_refs.items():
                by_store.setdefault(store.id, (store, []))[1].append((s, b, r))
            for store, entries in by_store.values():
                slots = torch.tensor([s for s, _b, _r in entries],
                                     dtype=torch.int64)
                m.index_copy_(0, slots.to(self.device),
                              store.gather([(b, r) for _s, b, r in entries]))
        if prenorm:
            m = m / (torch.linalg.norm(m, dim=1, keepdim=True) + 1e-12)
        self._dev_matrix = (token, m)
        return m

    def host_matrix(self) -> np.ndarray:
        """Host copy of all live vectors for the CPU serving tier: the host
        rows in f32, or, with device-resident rows, the consolidated
        matrix fetched once per index version as f16 (half the bytes)."""
        if (self._host_mirror is not None
                and self._host_mirror[0] == self._version):
            return self._host_mirror[1]
        if not self._dev_refs:
            m = self.matrix[: self.n].to("cpu", copy=True).numpy()
        else:
            dev = self._device_matrix(prenorm=False)[: self._dev_valid]
            m = dev.to(torch.float16).cpu().numpy().astype(np.float32)
        self._host_mirror = (self._version, m)
        return m

    def _scores(self, q: np.ndarray) -> np.ndarray:
        """Every live row's score against ``q``, in numpy on the host
        mirror (for cos, its L2-normalised copy, cached per version)."""
        m = self.host_matrix()
        if self.metric == "cos":
            if (self._host_mirror_norm is None
                    or self._host_mirror_norm[0] != self._version):
                mn = m / (np.linalg.norm(m, axis=1, keepdims=True) + 1e-12)
                self._host_mirror_norm = (self._version, mn)
            qn = q / (np.linalg.norm(q) + 1e-12)
            return self._host_mirror_norm[1] @ qn
        if self.metric == "l2sq":
            return -np.sum((m - q) ** 2, axis=1)
        return m @ q  # dot

    def _device_metric(self) -> tuple[bool, str]:
        """(prenorm, metric) of a search against the device matrix."""
        if self.metric == "cos":
            return True, "cos_prenorm"
        return False, self.metric

    # -- search ------------------------------------------------------------
    def search_batch(self, queries, k: int) -> list[list[tuple[int, float]]]:
        """Top-``k`` ``(key, score)`` per query, higher score = better: one
        scores launch for the whole batch against the device matrix."""
        if self.n == 0:
            return [[] for _ in queries]
        if isinstance(queries, torch.Tensor):
            qs = queries.reshape(len(queries), -1)
        else:
            qs = np.stack([_host_vec(q) for q in queries])
        prenorm, metric = self._device_metric()
        vals, idx = batched_topk(self._device_matrix(prenorm), qs, k, metric,
                                 n_valid=self._dev_valid)
        return [
            [(self.keys[int(i)], float(v)) for v, i in zip(vi, ii)]
            for vi, ii in zip(vals, idx)
        ]

    def search(self, query: Any, k: int, metadata_filter: str | None = None,
               tier: str = "auto") -> list[tuple[int, float]]:
        """Top-``k`` ``(key, score)`` of one query.  ``tier="cpu"`` serves
        from the host mirror in numpy (no device work per query); any
        other tier scores the device matrix, with only the (k,) results
        fetched.  With ``metadata_filter`` the device's full score vector
        is fetched and walked in order until ``k`` rows pass it."""
        if self.n == 0:
            return []
        if tier == "cpu" and metadata_filter is None:
            return self._top(self._scores(_host_vec(query)), k)
        if (self.mesh is not None and metadata_filter is None
                and not self._dev_refs and self.n >= k):
            return self._search_sharded(query, k)
        prenorm, metric = self._device_metric()
        m = self._device_matrix(prenorm)
        q = query if isinstance(query, torch.Tensor) else _host_vec(query)
        if metadata_filter is None:
            vals, idx = device_topk(m, q, k, metric, n_valid=self._dev_valid)
            return [(self.keys[int(i)], float(v)) for v, i in zip(vals, idx)]
        scores = device_topk_scores(m, q, metric)[: self._dev_valid]
        out = []
        for i in np.argsort(-scores, kind="stable"):
            key = self.keys[i]
            if _check_metadata(self.metadata.get(key), metadata_filter):
                out.append((key, float(scores[i])))
                if len(out) >= k:
                    break
        return out

    def _search_sharded(self, query, k: int) -> list[tuple[int, float]]:
        """Top-``k`` over the host rows split by rows over the mesh."""
        from ...ops import knn_sharded as ks

        bucket = ks.row_bucket(self.n, self.mesh.shape[self.mesh_axis])
        token = (self._version, bucket)
        if self._mesh_matrix is None or self._mesh_matrix[0] != token:
            self._mesh_matrix = (token, ks.shard_matrix(
                self.mesh, self.mesh_axis, self.matrix[: self.n], bucket))
        q = (query.detach().to("cpu", torch.float32).reshape(1, -1)
             if isinstance(query, torch.Tensor) else _host_vec(query)[None])
        vals, idx = ks.sharded_topk_device(
            self.mesh, self.mesh_axis, self._mesh_matrix[1], q, k,
            self.metric, self.n)
        return [(self.keys[int(i)], float(v))
                for v, i in zip(vals[0], idx[0]) if v != -np.inf]

    def _top(self, scores: np.ndarray, k: int) -> list[tuple[int, float]]:
        """The CPU tier's top-k: the JAX index's numpy selection."""
        kk = min(k, self.n)
        idx = (np.argpartition(-scores, kk - 1)[:kk]
               if kk < self.n else np.arange(self.n))
        order = idx[np.argsort(-scores[idx])]
        return [(self.keys[i], float(scores[i])) for i in order]


class USearchKnn(BruteForceKnn):
    """The JAX package's alias for the reference's USearch HNSW: exact
    search over the device matrix here."""


class IvfKnn(InnerIndex):
    """Inverted-file ANN: the scale tier (reference equivalent: USearch HNSW,
    usearch_integration.rs:21-80 — re-designed for dense matmuls).  Host
    numpy, as in the JAX package, with the same seeded draws: keys and
    scores equal the JAX index's on the same rows.

    Vectors live in ONE matrix laid out cluster-major by a trained coarse
    quantizer, so probing a cluster is a contiguous-block matmul (zero
    gather, zero pointer chasing).
    Search scores the C centroids (one small matmul), probes the `nprobe`
    best clusters' blocks, and exactly rescores their members.  Mutation is
    incremental: adds append to a per-cluster overflow tail; removes
    tombstone in place; the index re-trains and compacts when it outgrows
    its training set 4x or tombstones exceed 25%.
    """

    def __init__(
        self,
        dimensions: int | None = None,
        *,
        n_clusters: int = 256,
        nprobe: int = 16,
        metric: str = "cos",
        train_min: int = 4096,
        train_sample: int = 50_000,
        seed: int = 0,
        reserved_space: int = 1024,
    ):
        if metric not in ("cos", "dot", "l2sq"):
            raise ValueError(f"unsupported metric {metric!r}")
        self.dim = dimensions
        self.n_clusters = n_clusters
        self.nprobe = nprobe
        self.metric = metric
        self.train_min = train_min
        self.train_sample = train_sample
        self.seed = seed
        self.capacity = max(reserved_space, 16)
        self.matrix: np.ndarray | None = None  # normalized rows for cos
        self.keys: list[int] = []  # slot -> key
        self.slot_of: dict[int, int] = {}
        self.metadata: dict[int, Any] = {}
        self.alive: np.ndarray | None = None  # slot -> live?
        self.n_slots = 0
        self.n = 0  # live count
        self.centroids: np.ndarray | None = None
        self._cent_adj: np.ndarray | None = None  # -||c||^2 for l2sq assignment
        self.sqnorms: np.ndarray | None = None  # per-slot ||v||^2 (l2sq)
        # cluster-major layout: block_bounds[c]:block_bounds[c+1] are cluster
        # c's contiguous slots; later adds land in overflow[c] (slot lists)
        self.block_bounds: np.ndarray | None = None
        self.overflow: list[list[int]] = []
        self._trained_at = 0

    # -- storage ------------------------------------------------------------
    def _norm(self, vec: np.ndarray) -> np.ndarray:
        if self.metric == "cos":
            return vec / (np.linalg.norm(vec) + 1e-12)
        return vec

    def _ensure(self, dim: int) -> None:
        if self.matrix is None:
            self.dim = dim
            self.matrix = np.zeros((self.capacity, dim), dtype=np.float32)
            self.alive = np.zeros(self.capacity, bool)
            if self.metric == "l2sq":
                self.sqnorms = np.zeros(self.capacity, np.float32)

    def _grow(self) -> None:
        self.capacity *= 2
        new = np.zeros((self.capacity, self.dim), dtype=np.float32)
        new[: self.n_slots] = self.matrix[: self.n_slots]
        self.matrix = new
        na = np.zeros(self.capacity, bool)
        na[: self.n_slots] = self.alive[: self.n_slots]
        self.alive = na
        if self.sqnorms is not None:
            ns = np.zeros(self.capacity, np.float32)
            ns[: self.n_slots] = self.sqnorms[: self.n_slots]
            self.sqnorms = ns

    def add(self, key: int, item: Any, metadata: Any = None) -> None:
        vec = self._norm(_host_vec(item))
        self._ensure(vec.shape[0])
        if key in self.slot_of:
            self.remove(key)
        if self.n_slots == self.capacity:
            self._grow()
        slot = self.n_slots
        self.matrix[slot] = vec
        if self.sqnorms is not None:
            self.sqnorms[slot] = float(vec @ vec)
        self.alive[slot] = True
        self.slot_of[key] = slot
        self.keys.append(key)
        self.metadata[key] = metadata
        self.n_slots += 1
        self.n += 1
        if self.centroids is None:
            if self.n >= self.train_min:
                self._train()
        else:
            c = int(np.argmax(self._assign_scores(vec[None, :])[0]))
            self.overflow[c].append(slot)
            dead = self.n_slots - self.n
            if self.n >= 4 * max(self._trained_at, 1) or (
                self.n_slots > 64 and dead > self.n_slots // 4
            ):
                self._train()

    def remove(self, key: int) -> None:
        slot = self.slot_of.pop(key, None)
        if slot is None:
            return
        self.metadata.pop(key, None)
        self.alive[slot] = False  # tombstone; compaction happens at retrain
        self.n -= 1

    def _assign_scores(self, rows: np.ndarray) -> np.ndarray:
        """(B, C) centroid affinity; for l2sq this ranks by true distance."""
        s = rows @ self.centroids.T
        if self.metric == "l2sq":
            s = 2.0 * s + self._cent_adj[None, :]
        return s

    # -- quantizer ----------------------------------------------------------
    def _train(self) -> None:
        rng = np.random.default_rng(self.seed)
        live = np.flatnonzero(self.alive[: self.n_slots])
        n = len(live)
        if n == 0:
            return
        C = max(1, min(self.n_clusters, n // 8 or 1))
        sample_n = min(n, self.train_sample)
        sample = self.matrix[rng.choice(live, size=sample_n, replace=False)]
        # k-means: random init + a few matmul-assignment iterations
        cent = sample[rng.choice(sample_n, size=C, replace=False)].copy()
        for _ in range(6):
            if self.metric == "l2sq":
                adj = -np.sum(cent * cent, axis=1)
                assign = np.argmax(2.0 * (sample @ cent.T) + adj[None, :], axis=1)
            else:
                assign = np.argmax(sample @ cent.T, axis=1)
            for c in range(C):
                pts = sample[assign == c]
                if len(pts):
                    m = pts.mean(axis=0)
                    if self.metric == "cos":
                        m /= np.linalg.norm(m) + 1e-12
                    cent[c] = m
        self.centroids = cent.astype(np.float32)
        self._cent_adj = -np.sum(cent * cent, axis=1).astype(np.float32)
        # assign all live rows in chunks, then rebuild the matrix
        # cluster-major (compacting tombstones away)
        assigns = np.empty(n, np.int64)
        for s in range(0, n, 65536):
            rows = self.matrix[live[s : s + 65536]]
            assigns[s : s + len(rows)] = np.argmax(self._assign_scores(rows), axis=1)
        order = np.argsort(assigns, kind="stable")
        sorted_live = live[order]
        sorted_assigns = assigns[order]
        new_matrix = np.zeros((max(self.capacity, n), self.dim), np.float32)
        new_matrix[:n] = self.matrix[sorted_live]
        if self.sqnorms is not None:
            ns = np.zeros(len(new_matrix), np.float32)
            ns[:n] = self.sqnorms[sorted_live]
            self.sqnorms = ns
        old_keys = self.keys
        self.keys = [old_keys[s] for s in sorted_live]
        self.slot_of = {k: i for i, k in enumerate(self.keys)}
        self.matrix = new_matrix
        self.capacity = len(new_matrix)
        self.alive = np.zeros(self.capacity, bool)
        self.alive[:n] = True
        self.n_slots = n
        self.n = n
        counts = np.bincount(sorted_assigns, minlength=C)
        self.block_bounds = np.concatenate([[0], np.cumsum(counts)])
        self.overflow = [[] for _ in range(C)]
        self._trained_at = n

    # -- search -------------------------------------------------------------
    def search(self, query, k, metadata_filter=None):
        if self.n == 0:
            return []
        q = self._norm(_host_vec(query))
        qsq = float(q @ q)

        def _score_rows(rows_2d, sq_1d):
            sc = rows_2d @ q
            if self.metric == "l2sq":
                sc = 2.0 * sc - sq_1d - qsq
            return sc

        if self.centroids is None:
            # untrained: exact scan (small index)
            scores = _score_rows(
                self.matrix[: self.n_slots],
                self.sqnorms[: self.n_slots] if self.sqnorms is not None else None,
            )
            scores[~self.alive[: self.n_slots]] = -np.inf
            slots = np.arange(self.n_slots)
        else:
            cs = self._assign_scores(q[None, :])[0]
            np_probe = min(self.nprobe, len(cs))
            probe = np.argpartition(-cs, np_probe - 1)[:np_probe]
            slot_chunks = []
            score_chunks = []
            bb = self.block_bounds
            for c in probe:
                c = int(c)
                start, end = int(bb[c]), int(bb[c + 1])
                if end > start:
                    block_scores = _score_rows(
                        self.matrix[start:end],
                        self.sqnorms[start:end] if self.sqnorms is not None else None,
                    )
                    a = self.alive[start:end]
                    if not a.all():
                        block_scores = np.where(a, block_scores, -np.inf)
                    score_chunks.append(block_scores)
                    slot_chunks.append(np.arange(start, end))
                ov = self.overflow[c]
                if ov:
                    ov_arr = np.asarray(ov, np.int64)
                    ov_scores = _score_rows(
                        self.matrix[ov_arr],
                        self.sqnorms[ov_arr] if self.sqnorms is not None else None,
                    )
                    a = self.alive[ov_arr]
                    if not a.all():
                        ov_scores = np.where(a, ov_scores, -np.inf)
                    score_chunks.append(ov_scores)
                    slot_chunks.append(ov_arr)
            if not score_chunks:
                return []
            scores = np.concatenate(score_chunks)
            slots = np.concatenate(slot_chunks)
        if metadata_filter is None:
            kk = min(max(k * 4, k), len(scores))
            idx = (
                np.argpartition(-scores, kk - 1)[:kk]
                if kk < len(scores)
                else np.arange(len(scores))
            )
            order = idx[np.argsort(-scores[idx])]
        else:
            # a selective filter must scan past non-matching candidates
            # (BruteForceKnn parity), so rank ALL probed candidates
            order = np.argsort(-scores)
        out = []
        for i in order:
            if scores[i] == -np.inf:
                continue
            key = self.keys[int(slots[i])]
            if metadata_filter is not None and not _check_metadata(
                self.metadata.get(key), metadata_filter
            ):
                continue
            out.append((key, float(scores[i])))
            if len(out) >= k:
                break
        return out


class LshKnn(InnerIndex):
    """Locality-sensitive hashing ANN (reference: stdlib/ml/_lsh.py).

    Random-hyperplane buckets; search unions candidate buckets then scores
    exactly.  Host numpy, as in the JAX package, with the same seeded
    planes: keys and scores equal the JAX index's on the same rows.  Each
    row's norm is computed once, at ``add`` (the JAX index recomputes it
    for every candidate of every query; the value is the same)."""

    def __init__(self, dimensions: int | None = None, *, n_or: int = 8, n_and: int = 6,
                 bucket_length: float = 1.0, seed: int = 0, metric: str = "cos"):
        self.dim = dimensions
        self.n_or = n_or
        self.n_and = n_and
        self.seed = seed
        self.metric = metric
        self.planes: np.ndarray | None = None
        self.buckets: list[dict[bytes, set]] = [defaultdict(set) for _ in range(n_or)]
        self.vectors: dict[int, np.ndarray] = {}
        self.norms: dict[int, np.float32] = {}
        self.metadata: dict[int, Any] = {}

    def _ensure(self, dim: int) -> None:
        if self.planes is None:
            rng = np.random.default_rng(self.seed)
            self.planes = rng.normal(size=(self.n_or, self.n_and, dim)).astype(np.float32)
            self.dim = dim

    def _hashes(self, vec: np.ndarray) -> list[bytes]:
        bits = (np.einsum("oad,d->oa", self.planes, vec) > 0)
        return [bits[i].tobytes() for i in range(self.n_or)]

    def add(self, key: int, item: Any, metadata: Any = None) -> None:
        vec = _host_vec(item)
        self._ensure(vec.shape[0])
        if key in self.vectors:
            self.remove(key)
        self.vectors[key] = vec
        self.norms[key] = np.linalg.norm(vec)
        self.metadata[key] = metadata
        for i, h in enumerate(self._hashes(vec)):
            self.buckets[i][h].add(key)

    def remove(self, key: int) -> None:
        vec = self.vectors.pop(key, None)
        if vec is None:
            return
        self.norms.pop(key, None)
        self.metadata.pop(key, None)
        for i, h in enumerate(self._hashes(vec)):
            self.buckets[i][h].discard(key)

    def search(self, query, k, metadata_filter=None):
        if not self.vectors:
            return []
        q = _host_vec(query)
        self._ensure(q.shape[0])
        cands: set[int] = set()
        for i, h in enumerate(self._hashes(q)):
            cands |= self.buckets[i].get(h, set())
        if not cands:
            cands = set(self.vectors.keys())
        scored = []
        qn = q / (np.linalg.norm(q) + 1e-12)
        for key in cands:
            if metadata_filter is not None and not _check_metadata(
                self.metadata.get(key), metadata_filter
            ):
                continue
            v = self.vectors[key]
            if self.metric == "cos":
                s = float(v @ qn / (self.norms[key] + 1e-12))
            else:
                s = float(-np.sum((v - q) ** 2))
            scored.append((key, s))
        scored.sort(key=lambda t: -t[1])
        return scored[:k]


_TOKEN_RE = re.compile(r"\w+")


def _tokenize(text: str) -> list[str]:
    return [t.lower() for t in _TOKEN_RE.findall(text or "")]


class TantivyBM25(InnerIndex):
    """BM25 full-text index (reference: tantivy_integration.rs): a host
    inverted index with Okapi BM25 scoring, as in the JAX package."""

    def __init__(self, *, k1: float = 1.2, b: float = 0.75, **kwargs):
        self.k1, self.b = k1, b
        self.postings: dict[str, dict[int, int]] = defaultdict(dict)
        self.doc_len: dict[int, int] = {}
        self.metadata: dict[int, Any] = {}
        self.total_len = 0

    def add(self, key: int, item: Any, metadata: Any = None) -> None:
        if key in self.doc_len:
            self.remove(key)
        toks = _tokenize(item if isinstance(item, str) else str(item))
        for tok, c in Counter(toks).items():
            self.postings[tok][key] = c
        self.doc_len[key] = len(toks)
        self.total_len += len(toks)
        self.metadata[key] = metadata

    def remove(self, key: int) -> None:
        n = self.doc_len.pop(key, None)
        if n is None:
            return
        self.total_len -= n
        self.metadata.pop(key, None)
        for tok in list(self.postings.keys()):
            self.postings[tok].pop(key, None)
            if not self.postings[tok]:
                del self.postings[tok]

    def search(self, query, k, metadata_filter=None):
        if not self.doc_len:
            return []
        toks = _tokenize(query if isinstance(query, str) else str(query))
        n_docs = len(self.doc_len)
        avg_len = self.total_len / n_docs if n_docs else 1.0
        scores: dict[int, float] = defaultdict(float)
        for tok in toks:
            plist = self.postings.get(tok)
            if not plist:
                continue
            idf = math.log(1 + (n_docs - len(plist) + 0.5) / (len(plist) + 0.5))
            for key, tf in plist.items():
                dl = self.doc_len[key]
                scores[key] += idf * tf * (self.k1 + 1) / (
                    tf + self.k1 * (1 - self.b + self.b * dl / avg_len))
        out = [(key, s) for key, s in scores.items()
               if _check_metadata(self.metadata.get(key), metadata_filter)]
        out.sort(key=lambda t: -t[1])
        return out[:k]


class HybridIndex(InnerIndex):
    """Reciprocal-rank fusion over sub-indexes (reference:
    hybrid_index.py:14): each sub-index's match at rank r adds
    ``w / (k + r + 1)`` to its key.  A zero weight disables a sub-index
    entirely (no adds, removals or probes), so its items may be raw.
    Each probe and the fusion are recorded as ``index.probe`` /
    ``index.fuse`` spans."""

    def __init__(self, inner_indexes: list[InnerIndex], *, k: float = 60.0,
                 weights: list[float] | None = None):
        self.inner = inner_indexes
        self.k = k
        if weights is not None and len(weights) != len(inner_indexes):
            raise ValueError("weights must match inner_indexes length")
        self.weights = weights or [1.0] * len(inner_indexes)

    def add(self, key, item, metadata=None):
        # item is a tuple: one entry per sub-index
        for idx, it, w in zip(self.inner, item, self.weights):
            if w != 0.0:
                idx.add(key, it, metadata)

    def remove(self, key):
        for idx, w in zip(self.inner, self.weights):
            if w != 0.0:
                idx.remove(key)

    def search(self, query, k, metadata_filter=None):
        fused: dict[int, float] = defaultdict(float)
        for idx, q, w in zip(self.inner, query, self.weights):
            if w == 0.0:
                continue
            t0 = _time.perf_counter()
            matches = idx.search(q, k * 2, metadata_filter)
            record_span("index.probe", t0, _time.perf_counter(),
                        kind=type(idx).__name__, k=k * 2)
            for rank, (key, _score) in enumerate(matches):
                fused[key] += w / (self.k + rank + 1)
        t0 = _time.perf_counter()
        out = sorted(fused.items(), key=lambda t: -t[1])[:k]
        record_span("index.fuse", t0, _time.perf_counter(),
                    candidates=len(fused), k=k)
        return out
