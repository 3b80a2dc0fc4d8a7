"""Histogram ops (the DeviceHistogram subset of the reference's library,
``lsb/cub/cub/device/device_histogram.cuh`` — SURVEY.md L-10), plus the
digit-histogram primitive the radix engines use (the analog of
``rdxsrt_histogram``, ``msb/src/sort/cuda_radix_sort.h:666-802``).

Realization: one-hot compare + sum (vectorized, atomic-free), left to
XLA, in place of the reference's shared-memory atomics + RLE pre-sorting
tricks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["histogram_even", "digit_histogram"]


def histogram_even(
    x: jax.Array, num_bins: int, lo, hi, *, dtype=jnp.int32
) -> jax.Array:
    """Counts of x in num_bins equal-width bins spanning [lo, hi).

    ``lo``/``hi`` are host scalars (the reference's ``LevelT`` arguments,
    ``lsb/cub/cub/device/device_histogram.cuh`` HistogramEven).  Bin edges
    are computed host-side with exact rational arithmetic and compared
    directly against ``x`` — never through a float divide — so boundary
    values bin exactly even for full-range 32-bit inputs (a float32
    ``(x - lo) / width`` misbins keys above 2^24).
    """
    from fractions import Fraction

    import numpy as np

    if num_bins <= 0:
        raise ValueError("num_bins must be positive")
    xdt = np.dtype(x.dtype)
    span = Fraction(hi) - Fraction(lo)
    is_int = np.issubdtype(xdt, np.integer)
    info = np.iinfo(xdt) if is_int else np.finfo(np.float32)

    def _edge(j: int):
        """Smallest representable value of x's dtype inside bin j (the
        exact edge lo + j*span/num_bins, rounded up to the dtype grid)."""
        e = Fraction(lo) + Fraction(j) * span / num_bins
        if is_int:
            v = -((-e.numerator) // e.denominator)  # ceil
            return int(np.clip(v, int(info.min), int(info.max) + 1))
        t = np.float32(float(e))
        if Fraction(float(t)) < e:
            t = np.nextafter(t, np.float32(np.inf), dtype=np.float32)
        return t

    # count_ge[j] = #(x >= edge_j); bin j's count = count_ge[j] -
    # count_ge[j+1], with x < hi enforced by the exact top edge (x < hi is
    # equivalent to x < edge(num_bins) on the dtype grid).
    edges = [_edge(j) for j in range(num_bins + 1)]
    if is_int and Fraction(hi) > int(info.max):
        in_hi = jnp.ones(x.shape, bool)
    else:
        in_hi = x < jnp.asarray(edges[num_bins], x.dtype)
    ge = []
    for j, e in enumerate(edges):
        if is_int and e > int(info.max):
            ge.append(jnp.zeros((), dtype))
        else:
            cmp = (x >= jnp.asarray(e, x.dtype)) & in_hi
            ge.append(cmp.sum(dtype=dtype))
    counts = jnp.stack([ge[j] - ge[j + 1] for j in range(num_bins)])
    return counts


def digit_histogram(
    keys_u32: jax.Array, shift: int, bits: int, *, tiles: int = 1,
    dtype=jnp.int32,
) -> jax.Array:
    """Per-tile counts of the ``bits``-wide digit at ``shift``.

    keys_u32: (N,) twiddled keys with N divisible by tiles; returns
    (tiles, 2**bits).
    """
    r = 1 << bits
    keys_u32 = jnp.asarray(keys_u32)
    d = (keys_u32.reshape(tiles, -1) >> jnp.uint32(shift)) & jnp.uint32(r - 1)
    oh = d[:, :, None] == jnp.arange(r, dtype=jnp.uint32)
    return oh.sum(axis=1, dtype=dtype)
