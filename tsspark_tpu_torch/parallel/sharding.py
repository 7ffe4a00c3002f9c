"""Batch-width ladder of the serving engine's width buckets, the
backend's chunk sizes and the fit's compacted widths (the port's copy of
the JAX package's ``parallel.sharding`` width helpers)."""

from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def compacted_width(n_live: int, floor: int = 32, multiple: int = 1) -> int:
    """Padded batch width for ``n_live`` rows: the next power of two,
    floored at ``floor`` and rounded up to a ``multiple`` (a series-shard
    count, so a compacted width still divides evenly across shards), so
    widths walk one short ladder and every width is one the card has seen
    before."""
    w = next_pow2(max(int(n_live), 1))
    return pad_to_multiple(max(w, int(floor)), max(int(multiple), 1))
