"""Single-device attention reference (counterpart of
``pathway_tpu/models/attention.py``'s ``reference_attention``; the ring
and Ulysses sequence-parallel strategies are not ported yet)."""

from __future__ import annotations

import math

import torch


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """(B, T, H, hd) attention: scores in ``q``'s dtype, a ``-1e30``
    causal mask, softmax in f32, the f32 probabilities times ``v``, the
    result cast to ``q``'s dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        T = q.shape[1]
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                     device=q.device))
        s = s.masked_fill(~mask[None, None], -1e30)
    p = torch.softmax(s.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


__all__ = ["reference_attention"]
