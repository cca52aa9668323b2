"""Row-sharded brute-force KNN over a mesh of shards.

Counterpart of ``pathway_tpu/ops/knn_sharded.py``.  The (N, d) index
matrix is padded to a row bucket and split by rows over the shards of a
``parallel/mesh.TPMesh`` (each shard's rows on its device, kept between
queries by the caller); the queries are replicated.  Each shard scores
its rows, masks the padding rows to ``-inf`` by their global row id (so
padding never displaces a real neighbour, even a negative-scoring one),
and takes a local top-k; the (value, global index) candidates of every
shard are gathered on shard 0 and merged by one more top-k.

Every top-k is :func:`ops.knn.topk_lower_index_first`, ``lax.top_k``'s
order: the candidates are gathered in shard order and each shard's list
is in that order, so among equal scores the lower global row comes
first, as in the JAX function.  The local product is a plain
``torch.matmul`` (``ops.knn.metric_scores`` with ``q @ m.T``): in the
JAX package too it is XLA, not the Pallas scores kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .knn import metric_scores, topk_lower_index_first


def _matmul_scores(q: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return q @ m.T


def row_bucket(n: int, n_dev: int) -> int:
    """A power-of-two row count >= n, rounded up to a multiple of
    ``n_dev`` (the JAX package's static shapes across incremental
    adds)."""
    b = max(n_dev, 1)
    while b < n:
        b *= 2
    return b + (-b) % n_dev


def shard_matrix(mesh, axis: str, matrix, bucket: int) -> list[torch.Tensor]:
    """``matrix`` (N, d) padded with zero rows to ``bucket`` and split by
    rows over the mesh's ``axis``: one f32 (bucket / n, d) tensor a
    shard, on its device."""
    n_dev = mesh.shape[axis]
    m = torch.as_tensor(np.asarray(matrix, np.float32)
                        if not isinstance(matrix, torch.Tensor) else matrix)
    m = m.to(torch.float32)
    n, d = m.shape
    if bucket % n_dev or bucket < n:
        raise ValueError(f"bucket {bucket} for {n} rows over {n_dev} shards")
    if bucket > n:
        m = torch.cat([m, m.new_zeros((bucket - n, d))])
    return [part.to(dev).contiguous()
            for part, dev in zip(m.chunk(n_dev), mesh.devices)]


def sharded_topk_device(mesh, axis: str, device_matrix: list[torch.Tensor],
                        queries, k: int, metric: str,
                        n_live: int) -> tuple[np.ndarray, np.ndarray]:
    """(Q, k) top scores and global row indices over a matrix laid out by
    :func:`shard_matrix`; rows with a global id >= ``n_live`` are
    padding.  Only the merged (Q, k) results are fetched."""
    if axis not in mesh.shape:
        raise ValueError(f"the mesh has axes {mesh.axis_names}, not {axis!r}")
    q =torch.as_tensor(np.asarray(queries, np.float32)
                        if not isinstance(queries, torch.Tensor) else queries)
    q = q.to(torch.float32).reshape(-1, device_matrix[0].shape[1])
    vals, idxs = [], []
    for i, (shard_rows, dev) in enumerate(zip(device_matrix, mesh.devices)):
        rows = shard_rows.shape[0]
        offset = i * rows
        scores = metric_scores(q.to(dev), shard_rows, metric, _matmul_scores)
        row_ids = offset + torch.arange(rows, device=dev)
        scores = scores.masked_fill(row_ids[None, :] >= n_live, float("-inf"))
        v, ix = topk_lower_index_first(scores, min(k, rows))
        vals.append(v)
        idxs.append(ix + offset)
    dev0 = mesh.devices[0]
    all_vals = torch.cat([v.to(dev0) for v in vals], dim=1)
    all_idx = torch.cat([ix.to(dev0) for ix in idxs], dim=1)
    mvals, mpos = topk_lower_index_first(all_vals, min(k, all_vals.shape[1]))
    midx = torch.gather(all_idx, 1, mpos)
    return mvals.cpu().numpy(), midx.cpu().numpy()


def sharded_topk(mesh, axis: str, matrix, queries, k: int,
                 metric: str = "cos") -> tuple[np.ndarray, np.ndarray]:
    """One-shot form: shard ``matrix`` and search it."""
    n = len(matrix)
    bucket = row_bucket(n, mesh.shape[axis])
    dm = shard_matrix(mesh, axis, matrix, bucket)
    return sharded_topk_device(mesh, axis, dm, queries, k, metric, n)


__all__ = ["row_bucket", "shard_matrix", "sharded_topk",
           "sharded_topk_device"]
