"""Sequence-parallel exact attention over a mesh of shards, and the
single-device reference.

Counterpart of ``pathway_tpu/models/attention.py``.  A (B, T, H, D)
sequence is split along T over the shards of a ``parallel/mesh.TPMesh``
(:func:`shard_sequence`); every function here takes the mesh and the
list of sequence shards, one (B, T/n, H, D) tensor a shard on its
device, and returns the output in the same layout.  Two strategies:

- ring (:func:`ring_attention`): each shard keeps its queries while the
  K/V blocks rotate around the ring (``TPMesh.ppermute``), n steps; a
  streaming log-sum-exp merge in f32 keeps the result exact, and a
  shard's score block is (T/n, T/n);
- Ulysses (:func:`ulysses_attention`): an all-to-all re-shards the
  sequence shards into head shards (B, T, H/n, D), each shard computes
  full attention over its heads, and a second all-to-all restores the
  sequence layout; it needs ``H % n == 0``.

:func:`make_sequence_parallel_attention` picks one as the JAX package
does.  The attention math is plain PyTorch, as in the JAX package it is
XLA (no Pallas kernel).  One controller issues every shard's work in
turn; between distinct cards the rotations are peer copies.
"""

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


def shard_sequence(x: torch.Tensor, mesh) -> list[torch.Tensor]:
    """(B, T, H, D) -> one (B, T/n, H, D) shard a device of ``mesh``."""
    n = mesh.size
    if x.shape[1] % n:
        raise ValueError(f"sequence length {x.shape[1]} does not split over "
                         f"{n} shards")
    return [part.to(dev).contiguous()
            for part, dev in zip(x.chunk(n, dim=1), mesh.devices)]


def _block_attn(q, k, v, mask):
    """One (query block, key block) pair: ``(m, l, o)`` partials, the
    row maxima (B, H, Tq) with fully masked rows at 0, the exp sums
    (B, H, Tq) and the unnormalised output (B, Tq, H, D)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s.masked_fill(~mask[None, None], float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    return m_safe, p.sum(dim=-1), torch.einsum("bhqk,bkhd->bqhd", p, v)


def ring_attention(mesh, qs, ks, vs, causal: bool = False) -> list:
    """Ring attention over sequence shards: shard ``i`` holds query
    positions ``[i * Tl, (i + 1) * Tl)``; at step ``t`` it holds the K/V
    block of shard ``(i - t) % n`` and folds that block's partials into
    its running (max, sum, output) in f32."""
    n = mesh.size
    B, Tl, H, D = qs[0].shape
    state = []
    for q in qs:
        dev = q.device
        state.append((torch.full((B, H, Tl), float("-inf"), device=dev),
                      torch.zeros((B, H, Tl), device=dev),
                      torch.zeros((B, Tl, H, D), device=dev)))
    k_cur, v_cur = list(ks), list(vs)
    for step in range(n):
        for i, q in enumerate(qs):
            mask = None
            if causal:
                src = (i - step) % n
                pos = torch.arange(Tl, device=q.device)
                mask = (i * Tl + pos)[:, None] >= (src * Tl + pos)[None, :]
            bm, bl, bo = _block_attn(q, k_cur[i], v_cur[i], mask)
            bm, bl, bo = bm.float(), bl.float(), bo.float()
            m, l, o = state[i]
            new_m = torch.maximum(m, bm)
            c_old = torch.where(torch.isfinite(m), torch.exp(m - new_m),
                                torch.zeros_like(m))
            c_new = torch.where(bl > 0, torch.exp(bm - new_m),
                                torch.zeros_like(bm))
            state[i] = (new_m, l * c_old + bl * c_new,
                        o * c_old.transpose(1, 2)[..., None]
                        + bo * c_new.transpose(1, 2)[..., None])
        if step < n - 1:
            k_cur, v_cur = mesh.ppermute(k_cur), mesh.ppermute(v_cur)
    return [(o / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None])
            .to(q.dtype) for q, (_m, l, o) in zip(qs, state)]


def ulysses_attention(mesh, qs, ks, vs, causal: bool = False) -> list:
    """Ulysses attention over sequence shards: all-to-all to head shards,
    full attention over each shard's H/n heads, all-to-all back."""
    n = mesh.size
    H = qs[0].shape[2]
    if H % n:
        raise ValueError(
            f"ulysses attention needs n_heads % axis size == 0, got "
            f"{H} % {n} (use ring attention instead)")

    def seq_to_heads(parts):
        return mesh.all_to_all(parts, split_dim=2, concat_dim=1)

    out = []
    for qh, kh, vh in zip(seq_to_heads(qs), seq_to_heads(ks),
                          seq_to_heads(vs)):
        s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(qh.shape[-1])
        if causal:
            T = qh.shape[1]
            mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                         device=qh.device))
            s = s.masked_fill(~mask[None, None], -1e30)
        p = torch.softmax(s.float(), dim=-1).to(qh.dtype)
        out.append(torch.einsum("bhqk,bkhd->bqhd", p, vh))
    return mesh.all_to_all(out, split_dim=1, concat_dim=2)


def _axis_size(mesh, axis_name: str) -> int:
    if axis_name not in mesh.shape or len(mesh.shape) != 1:
        raise ValueError(f"sequence parallelism runs over a one-axis mesh "
                         f"named {axis_name!r}, got axes {mesh.axis_names}")
    return mesh.shape[axis_name]


def make_ring_attention(mesh, axis_name: str = "sp", causal: bool = False):
    """``fn(q_shards, k_shards, v_shards) -> out_shards``, ring
    attention over ``mesh``."""
    _axis_size(mesh, axis_name)

    def fn(qs, ks, vs):
        return ring_attention(mesh, qs, ks, vs, causal=causal)

    fn.strategy = "ring"
    return fn


def make_ulysses_attention(mesh, axis_name: str = "sp",
                           causal: bool = False):
    """``fn(q_shards, k_shards, v_shards) -> out_shards``, Ulysses
    attention over ``mesh``; raises a readable error unless the head
    count divides by the axis size."""
    _axis_size(mesh, axis_name)

    def fn(qs, ks, vs):
        return ulysses_attention(mesh, qs, ks, vs, causal=causal)

    fn.strategy = "ulysses"
    return fn


def make_sequence_parallel_attention(mesh, axis_name: str = "sp", *,
                                     causal: bool = False, n_heads: int,
                                     seq_len: int | None = None,
                                     strategy: str = "auto"):
    """Pick the sequence-parallel strategy: ``"ring"``, ``"ulysses"``, or
    ``"auto"`` — Ulysses when the heads divide over the axis and the full
    score block is modest (T <= 8192), else ring."""
    n = _axis_size(mesh, axis_name)
    if strategy == "auto":
        fits = seq_len is None or seq_len <= 8192
        strategy = "ulysses" if (n_heads % n == 0 and fits) else "ring"
    if strategy == "ulysses":
        if n_heads % n != 0:
            raise ValueError(
                f"ulysses needs n_heads % axis size == 0, got {n_heads} % {n}")
        return make_ulysses_attention(mesh, axis_name, causal=causal)
    if strategy != "ring":
        raise ValueError(f"unknown sequence-parallel strategy {strategy!r}")
    return make_ring_attention(mesh, axis_name, causal=causal)


__all__ = ["make_ring_attention", "make_sequence_parallel_attention",
           "make_ulysses_attention", "reference_attention", "ring_attention",
           "shard_sequence", "ulysses_attention"]
