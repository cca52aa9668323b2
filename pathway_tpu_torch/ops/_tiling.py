"""Shape bucketing shared by the host-facing embedders.

The JAX package's ``pad_to`` is not carried over: the port's kernels
mask ragged edges themselves, so nothing pads to a tile multiple."""

from __future__ import annotations


def bucket_for(n: int, buckets) -> int:
    """Smallest bucket >= n (the largest bucket when none fits).

    Padding batch sizes to a fixed ladder keeps the set of shapes a
    serving process runs bounded."""
    buckets = sorted(int(b) for b in buckets)
    if not buckets:
        return n
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]
