"""Prefix-scan ops (the DeviceScan subset of the reference's kernel library,
``lsb/cub/cub/device/device_scan.cuh`` — SURVEY.md L-10, scoped to what the
query-execution seed needs), lowered to XLA's scans.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["inclusive_sum", "exclusive_sum", "inclusive_scan",
           "exclusive_scan", "segmented_sum"]


def inclusive_sum(x: jax.Array, axis: int = -1) -> jax.Array:
    return jnp.cumsum(jnp.asarray(x), axis=axis)


def exclusive_sum(x: jax.Array, axis: int = -1) -> jax.Array:
    x = jnp.asarray(x)
    return jnp.cumsum(x, axis=axis) - x


def inclusive_scan(x: jax.Array, op, axis: int = -1) -> jax.Array:
    """Generic inclusive scan with an associative op (e.g. jnp.maximum)."""
    return jax.lax.associative_scan(op, x, axis=axis)


def exclusive_scan(x: jax.Array, op, identity, axis: int = -1) -> jax.Array:
    inc = jax.lax.associative_scan(op, x, axis=axis)
    shifted = jnp.roll(inc, 1, axis=axis)
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(0, 1)
    return shifted.at[tuple(idx)].set(identity)


def segmented_sum(x: jax.Array, segment_ids: jax.Array, num_segments: int):
    """Per-segment sums via a one-hot reduction (no scatter)."""
    oh = (
        segment_ids[:, None] == jnp.arange(num_segments, dtype=segment_ids.dtype)
    ).astype(x.dtype)
    return (x[:, None] * oh).sum(axis=0)
