"""Test/benchmark data generators.

Analog of the reference's device-side generators
(``msb/tests/data_gen.h:34-85``):

* uniform random keys (cuRAND there; ``jax.random`` bits here),
* **entropy reduction by ANDing k independent uniform draws** — the skew /
  duplicate-keys stressor (``data_gen.h:44-76``; entropy level 0 produces the
  all-zero constant array, matching ``test_sort_keys.cu:126``),
* enumerated values 0..N-1 for O(N) unstable-pair verification
  (``data_gen.h:79-85``),

plus a Zipfian generator for the skewed-distribution benchmark configs that
the north-star adds on top of the reference.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "random_keys",
    "entropy_keys",
    "enumerated_values",
    "zipf_keys",
]


def _random_bits(key: jax.Array, n: int, bits: int) -> jax.Array:
    if bits == 32:
        return jax.random.bits(key, (n,), dtype=jnp.uint32)
    hi_key, lo_key = jax.random.split(key)
    hi = jax.random.bits(hi_key, (n,), dtype=jnp.uint32)
    lo = jax.random.bits(lo_key, (n,), dtype=jnp.uint32)
    return hi.astype(jnp.uint64) << jnp.uint64(32) | lo.astype(jnp.uint64)


def random_keys(key: jax.Array, n: int, dtype=jnp.uint32) -> jax.Array:
    """Uniform random keys of any supported key dtype."""
    dtype = jnp.dtype(dtype)
    bits = dtype.itemsize * 8
    raw = _random_bits(key, n, bits)
    if dtype in (jnp.dtype(jnp.uint32), jnp.dtype(jnp.uint64)):
        return raw
    if dtype == jnp.dtype(jnp.int32):
        return raw.view(jnp.int32)
    if dtype == jnp.dtype(jnp.int64):
        return raw.view(jnp.int64)
    if dtype == jnp.dtype(jnp.float32):
        # uniform in [0, 1) like the LSB driver's curandGenerateUniform
        # (lsb/sort.cu:125-131)
        return jax.random.uniform(key, (n,), dtype=jnp.float32)
    if dtype == jnp.dtype(jnp.float64):
        return jax.random.uniform(key, (n,), dtype=jnp.float64)
    raise TypeError(f"unsupported dtype {dtype}")


def entropy_keys(key: jax.Array, n: int, entropy_level: int, dtype=jnp.uint32):
    """AND of ``entropy_level`` uniform draws; level 0 => all zeros.

    Matches the reference's entropy ladder (``data_gen.h:44-76``): higher
    levels bias bits toward 0, collapsing the key distribution toward heavy
    duplication; level 1 is fully uniform.
    """
    dtype = jnp.dtype(dtype)
    bits = dtype.itemsize * 8
    if entropy_level == 0:
        return jnp.zeros((n,), dtype=jnp.uint32 if bits == 32 else jnp.uint64).view(
            dtype
        )
    out = None
    for sub in jax.random.split(key, entropy_level):
        draw = _random_bits(sub, n, bits)
        out = draw if out is None else out & draw
    if dtype in (jnp.dtype(jnp.uint32), jnp.dtype(jnp.uint64)):
        return out
    return out.view(dtype)


def enumerated_values(n: int, dtype=jnp.uint32) -> jax.Array:
    """0..N-1 payload for permutation-checksum pair verification
    (``data_gen.h:79-85``, used by ``test_sort_pairs.cu:141-175``)."""
    return jnp.arange(n, dtype=dtype)


def zipf_keys(
    key: jax.Array, n: int, *, alpha: float = 1.1, universe: int = 1 << 20,
    dtype=jnp.uint64,
) -> jax.Array:
    """Zipfian-distributed keys over ``universe`` distinct values.

    Inverse-CDF sampling on a precomputed numpy table (host-side, test/bench
    only).  Exercises splitter sampling + skew handling (BASELINE config 4).
    """
    ranks = np.arange(1, universe + 1, dtype=np.float64)
    weights = ranks ** (-alpha)
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    u = np.asarray(jax.random.uniform(key, (n,), dtype=jnp.float32), dtype=np.float64)
    idx = np.searchsorted(cdf, u).astype(np.uint64)
    # spread ids over the key space while keeping heavy duplication
    bits = jnp.dtype(dtype).itemsize * 8
    spread = (idx * np.uint64(0x9E3779B97F4A7C15)) if bits == 64 else (
        (idx * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)
    )
    arr = spread.astype(np.uint64 if bits == 64 else np.uint32)
    return jnp.asarray(arr).view(dtype)
