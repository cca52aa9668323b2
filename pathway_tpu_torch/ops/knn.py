"""KNN metrics and top-k built around a raw ``(Q, d) x (N, d)^T`` score
product.

Counterpart of ``pathway_tpu/ops/knn.py``.  Higher score = better for
every metric: ``cos`` (both sides L2-normalized), ``cos_prenorm`` (the
matrix rows are already L2-normalized, so only the query is),  ``dot``,
and ``l2sq`` as the negated squared distance ``2 q.m - |m|^2 - |q|^2``
(the matmul form keeps the product the only O(Q N d) work).  The raw
product is ``knn_scores`` (``ops/knn_cuda.py``): the CUDA kernel for
tensors on the card (its GEMM at 16 queries or more, its GEMV below),
``q @ m.T`` for tensors on the CPU.

Top-k breaks ties by the lower index first, as ``lax.top_k`` does, so a
corpus with duplicate rows returns the reference's keys in the
reference's order, down to the set at the k-th place.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .knn_cuda import knn_scores

METRICS = ("cos", "dot", "l2sq")


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=1, keepdim=True) + 1e-12)


def metric_scores(queries: torch.Tensor, matrix: torch.Tensor, metric: str,
                  scores_fn: Callable) -> torch.Tensor:
    """(Q, N) f32 scores of ``metric``; ``scores_fn(q, m)`` computes the
    raw product (the CUDA kernel on the card, ``q @ m.T`` on the CPU)."""
    q = queries.float()
    m = matrix.float()
    if metric == "cos":
        return scores_fn(_l2_normalize(q).contiguous(),
                         _l2_normalize(m).contiguous())
    if metric == "cos_prenorm":
        return scores_fn(_l2_normalize(q).contiguous(), m.contiguous())
    if metric == "dot":
        return scores_fn(q.contiguous(), m.contiguous())
    if metric == "l2sq":
        s = scores_fn(q.contiguous(), m.contiguous())
        return (2.0 * s - torch.sum(m * m, dim=1)[None, :]
                - torch.sum(q * q, dim=1)[:, None])
    raise ValueError(f"unknown metric {metric!r}; expected one of "
                     f"{METRICS + ('cos_prenorm',)}")


def topk_lower_index_first(scores: torch.Tensor,
                           k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` highest scores along the last
    dim, ordered as ``lax.top_k`` orders them: by score in its total
    order (NaN above +inf, +0 above -0), and among equal scores by the
    lower index first.

    ``torch.topk`` promises no order among ties.  Here each f32 score maps
    to an int32 key of the same total order (negative floats flip their
    magnitude bits), and a stable descending sort of the keys keeps the
    lower index first among equal ones (its cost on the card, beside
    ``torch.topk``'s, is in PERF.md)."""
    s = scores.float().contiguous()
    bits = s.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return torch.gather(s, -1, idx), idx


def to_device(matrix, device) -> torch.Tensor:
    """An index matrix (numpy or tensor) as one f32 tensor on ``device``,
    pinned there once so that queries do not upload the corpus again."""
    if not isinstance(matrix, torch.Tensor):
        matrix = torch.from_numpy(np.asarray(matrix, np.float32))
    return matrix.to(device=device, dtype=torch.float32)


def device_topk_scores(matrix: torch.Tensor, query,
                       metric: str = "cos") -> np.ndarray:
    """The full (N,) score vector of one query, computed on the matrix's
    device and fetched to the host (the metadata-filtered search walks
    it in order)."""
    q = to_device(query, matrix.device).reshape(1, -1)
    return metric_scores(q, matrix, metric, knn_scores)[0].cpu().numpy()


def batched_topk(matrix: torch.Tensor, queries, k: int, metric: str = "cos",
                 n_valid: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(Q, k) top-k values and indices for a batch of queries against a
    matrix on the device: one scores launch for the whole batch, top-k
    on the device, only the (Q, k) results fetched.  ``n_valid`` masks
    bucket padding rows (scored -inf)."""
    nv = int(matrix.shape[0]) if n_valid is None else int(n_valid)
    q = to_device(queries, matrix.device)
    scores = metric_scores(q, matrix, metric, knn_scores)
    if nv < scores.shape[-1]:  # bucket padding rows
        scores[:, nv:] = float("-inf")
    vals, idx = topk_lower_index_first(scores, min(k, nv))
    return vals.cpu().numpy(), idx.cpu().numpy()


def device_topk(matrix: torch.Tensor, query, k: int, metric: str = "cos",
                n_valid: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Single-query top-k computed entirely on the matrix's device; only
    the (k,) values and indices come back to the host.  ``n_valid``
    masks bucket padding rows."""
    vals, idx = batched_topk(matrix, to_device(query, matrix.device)
                             .reshape(1, -1), k, metric, n_valid)
    return vals[0], idx[0]
