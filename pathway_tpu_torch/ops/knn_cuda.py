"""Batched exact KNN: scores from the CUDA kernel, then top-k.

Counterpart of ``pathway_tpu/ops/knn_pallas.py``: the Pallas
``_scores_kernel`` becomes ``csrc/knn_scores.cu`` in f32 FMA, as a
register-blocked GEMM for batches of ``GEMM_MIN_Q`` queries or more and
a streaming GEMV below (one query's latency path); both count as
``knn_scores`` launches.  Top-k runs after it, outside the kernel, in
``lax.top_k``'s order (``ops/knn.py`` ``topk_lower_index_first``), as
the JAX package runs ``lax.top_k`` outside its kernel.  CPU tensors take the
plain version (``q @ m.T`` in f32); CUDA tensors launch the kernel or
raise.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..obs.profiler import add_kernel_cost
from . import _cuda

_SOURCE = "knn_scores.cu"
#: batches of at least this many queries take the GEMM, smaller ones the GEMV
GEMM_MIN_Q = 16


def knn_scores_reference(queries: torch.Tensor,
                         matrix: torch.Tensor) -> torch.Tensor:
    """Plain version: (Q, d) x (N, d)^T -> (Q, N) in f32."""
    return queries.float() @ matrix.float().T


def knn_scores_cuda(queries: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Launch the scores kernel on f32, contiguous CUDA tensors."""
    _cuda.check(queries, "queries", dtype=torch.float32, ndim=2)
    _cuda.check(matrix, "matrix", dtype=torch.float32, ndim=2,
                device=queries.device)
    Q, d = queries.shape
    N = matrix.shape[0]
    if matrix.shape[1] != d:
        raise ValueError(f"matrix dim {matrix.shape[1]} != query dim {d}")
    out = torch.empty((Q, N), dtype=torch.float32, device=queries.device)
    if Q and N:
        fn = "pw_knn_scores_gemm" if Q >= GEMM_MIN_Q else "pw_knn_scores_gemv"
        _cuda.launch(_SOURCE, fn, "knn_scores", queries.device,
                     queries.data_ptr(), matrix.data_ptr(), out.data_ptr(),
                     Q, N, d)
        add_kernel_cost(2.0 * Q * N * d, 4.0 * (Q * d + N * d + Q * N))
    return out


def knn_scores(queries: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if queries.device.type == "cuda":
        return knn_scores_cuda(queries, matrix)
    return knn_scores_reference(queries, matrix)


def knn_topk(matrix, queries, k: int, metric: str = "cos", *,
             device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Batched exact KNN over ``matrix`` (N, d): returns ``(scores (Q, k),
    indices (Q, k))`` as tensors on ``device``.  Inputs may be numpy
    arrays or tensors; they are moved to ``device`` first.  Ties rank the
    lower index first, as ``lax.top_k`` ranks them."""
    from .knn import metric_scores, to_device, topk_lower_index_first

    dev = resolve_device(device)
    m, q = to_device(matrix, dev), to_device(queries, dev)
    scores = metric_scores(q, m, metric, knn_scores)
    return topk_lower_index_first(scores, min(k, m.shape[0]))
