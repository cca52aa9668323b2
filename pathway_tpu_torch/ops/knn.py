"""KNN metrics built around a raw ``(Q, d) x (N, d)^T`` score product.

Higher score = better for every metric: ``cos`` (both sides
L2-normalized), ``dot``, and ``l2sq`` as the negated squared distance
``2 q.m - |m|^2 - |q|^2`` (the matmul form keeps the product the only
O(Q N d) work)."""

from __future__ import annotations

from typing import Callable

import torch

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
    if metric == "dot":
        return scores_fn(q.contiguous(), m.contiguous())
    if metric == "l2sq":
        s = scores_fn(q.contiguous(), m.contiguous())
        return (2.0 * s - torch.sum(m * m, dim=1)[None, :]
                - torch.sum(q * q, dim=1)[:, None])
    raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")
