"""The slice of ``jax.random`` the sampling head draws from, bit for bit.

A sampled request's tokens are a pure function of its prompt, its seed
and the index of each emitted token: the Gumbel noise of a row's n-th
token is keyed by ``fold_in(fold_in(prng_key(0), seed), n)``.  Matching
the JAX package's keys and bits exactly (not just in distribution) keeps
fixed-seed sampled output identical across the two packages, and across
preemption, restart and speculation inside either.

Threefry-2x32 (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC 2011) as ``jax._src.prng`` computes it, with
``jax_threefry_partitionable=True`` (the default since jax 0.5): element
``j`` of ``random_bits_32(key, n)`` is ``x0 ^ x1`` of
``threefry2x32(key, (0, j))``.

Everything is integer math on int64 tensors masked to 32 bits, batched
over rows (one key per row), on any device: torch's uint32 supports few
ops, and an int64 shift or add gives the same bits on the CPU and on the
card.  A key is an ``(..., 2)`` int64 tensor holding two uint32 words.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
# the key schedule's parity constant and the two rotation sets
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32: the mantissa bits a uniform draw keeps, and the smallest normal
# number, the uniform's lower bound in the Gumbel draw
_NMANT = 23
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block (20 rounds) of the count pair ``(x0, x1)``
    under ``key``.  ``key`` (..., 2); ``x0``/``x1`` broadcast against
    ``key[..., 0]``; all int64 holding uint32 values.  Returns the two
    output words, int64."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int = 0, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``(0, seed)`` as
    uint32 words (a negative seed wraps, as ``jnp.asarray(seed,
    "uint32")`` does).  Built by fills, with no host-to-device copy, so
    a CUDA graph can capture it."""
    key = torch.zeros(2, dtype=torch.int64, device=device)
    key[1:].fill_(int(seed) & _MASK)
    return key


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``, row-wise: ``threefry2x32(key, (0,
    uint32(data)))``.  ``key`` (..., 2); ``data`` an int or an int tensor
    broadcasting against ``key[..., 0]`` (negative values wrap to
    uint32).  Returns the new keys, (..., 2) int64."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    y0, y1 = threefry2x32(key, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits_32(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), "uint32")`` per row: (..., n) int64
    holding uint32 values."""
    j = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., None, :], torch.zeros_like(j), j)
    return y0 ^ y1


def uniform_tiny(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)``
    per row: the top 23 bits as a mantissa of [1, 2), minus 1, scaled into
    [tiny, 1)."""
    bits = (random_bits_32(key, n) >> (32 - _NMANT)) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    # f32: (1 - tiny) rounds to 1, so this is f + tiny, as in JAX
    return torch.clamp(f * (1.0 - _TINY) + _TINY, min=_TINY)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` per row (mode "low"):
    ``-log(-log(u))`` of :func:`uniform_tiny`.  The bits are JAX's
    exactly; the float result is within the two backends' ``log``
    rounding of JAX's."""
    return -torch.log(-torch.log(uniform_tiny(key, n)))


__all__ = ["KS_PARITY", "ROTATIONS", "fold_in", "gumbel", "prng_key",
           "random_bits_32", "threefry2x32", "uniform_tiny"]
