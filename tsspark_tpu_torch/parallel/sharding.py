"""Batch-width ladder of the serving engine's width buckets and the
backend's chunk sizes (the port's copy of the JAX package's
``parallel.sharding`` width helpers)."""

from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def compacted_width(n_live: int, floor: int = 32) -> int:
    """Padded batch width for ``n_live`` rows: the next power of two,
    floored at ``floor``, so widths walk one short ladder and every width
    is one the card has seen before."""
    return max(next_pow2(max(int(n_live), 1)), int(floor))
