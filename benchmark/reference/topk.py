"""Exact cosine top-k over an index that is made again, block by block,
from its seed: the yardstick of the KNN search."""

from __future__ import annotations

import torch

from .precision import exact_f32, tf32


def cosine_topk(queries: torch.Tensor, blocks, k: int,
                lower_precision: bool = False):
    """``(values, ids)`` (Q, k) of the best cosine scores of float32
    ``queries`` (Q, d) over the rows that ``blocks`` yields in order (each
    a (n, d) float32 tensor), ids counting rows from 0; ties to the lower
    id.  ``lower_precision`` scores in TF32 (the control)."""
    q = queries.float()
    q = q / q.norm(dim=1, keepdim=True).clamp(min=1e-12)
    best_v = best_i = None
    base = 0
    ctx = tf32 if lower_precision else exact_f32
    with ctx():
        for m in blocks:
            m = m.float()
            m = m / m.norm(dim=1, keepdim=True).clamp(min=1e-12)
            s = q @ m.T
            v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
            i = i + base
            base += m.shape[0]
            if best_v is None:
                best_v, best_i = v, i
            else:
                v = torch.cat([best_v, v], dim=1)
                i = torch.cat([best_i, i], dim=1)
                # ties: the lower id first (a stable sort by id, then by
                # score descending)
                o = torch.argsort(i, dim=1)
                v, i = v.gather(1, o), i.gather(1, o)
                o = torch.sort(v, dim=1, descending=True, stable=True).indices
                best_v = v.gather(1, o)[:, :k]
                best_i = i.gather(1, o)[:, :k]
    return best_v, best_i


def cosine_scores(queries: torch.Tensor, blocks, ids: torch.Tensor
                  ) -> torch.Tensor:
    """(Q, k) exact float32 cosine scores of each query against the rows
    ``ids`` (Q, k) name, gathered from the blocks as they pass."""
    q = queries.float()
    q = q / q.norm(dim=1, keepdim=True).clamp(min=1e-12)
    out = torch.full(ids.shape, float("nan"), device=q.device)
    base = 0
    with exact_f32():
        for m in blocks:
            n = m.shape[0]
            inside = (ids >= base) & (ids < base + n)
            if inside.any():
                qi, kj = inside.nonzero(as_tuple=True)
                rows = m[ids[qi, kj] - base].float()
                rows = rows / rows.norm(dim=1, keepdim=True).clamp(min=1e-12)
                out[qi, kj] = (rows * q[qi]).sum(dim=1)
            base += n
    return out
