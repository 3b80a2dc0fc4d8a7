"""Order-preserving key <-> unsigned-bits mappings ("twiddling").

Re-design of the key-traits layer of the CUDA reference
(``lsb/cub/cub/util_type.cuh:966-1130`` — ``Traits<T>::TwiddleIn/TwiddleOut``):
a radix sort operates on unsigned bit patterns, so every supported key dtype
is mapped through an order-preserving bijection onto unsigned integers:

* unsigned ints  -> identity                       (util_type.cuh:966-971)
* signed ints    -> flip sign bit                  (util_type.cuh:1009-1014)
* floats         -> flip sign bit if positive,
                    flip ALL bits if negative      (util_type.cuh:1079-1085)

Descending order is realised by complementing the twiddled bits (the analog
of CUB's ``IS_DESCENDING`` template parameter,
``dispatch_radix_sort.cuh:746-760``), which keeps every downstream kernel
order-agnostic.

64-bit keys are decomposed into (hi, lo) uint32 planes immediately on
entry, and every engine sorts 32-bit operands only.  JAX disables 64-bit
types by default (``jax_enable_x64`` off), and the planes let the same
engines serve every key width.  This is a departure from the CUDA
reference, which sorts 64-bit registers directly.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "KeyTraits",
    "traits_for",
    "twiddle_in",
    "twiddle_out",
    "twiddle_planes_in",
    "twiddle_planes_out",
    "split64",
    "join64",
    "split64_host",
    "join64_host",
    "key_bits",
    "SUPPORTED_KEY_DTYPES",
]


_U32 = jnp.uint32
_I32 = jnp.int32


@dataclass(frozen=True)
class KeyTraits:
    """Static per-dtype information used by the sort engines."""

    name: str
    bits: int                 # total key bits (32 or 64)
    planes: int               # number of uint32 planes (1 or 2)
    is_float: bool
    is_signed: bool

    @property
    def max_twiddled(self) -> int:
        return (1 << self.bits) - 1


_TRAITS = {
    "uint32": KeyTraits("uint32", 32, 1, False, False),
    "int32": KeyTraits("int32", 32, 1, False, True),
    "float32": KeyTraits("float32", 32, 1, True, True),
    "uint64": KeyTraits("uint64", 64, 2, False, False),
    "int64": KeyTraits("int64", 64, 2, False, True),
    "float64": KeyTraits("float64", 64, 2, True, True),
}

SUPPORTED_KEY_DTYPES = tuple(_TRAITS)


def traits_for(dtype) -> KeyTraits:
    name = jnp.dtype(dtype).name
    if name not in _TRAITS:
        raise TypeError(
            f"unsupported key dtype {name!r}; supported: {SUPPORTED_KEY_DTYPES}"
        )
    return _TRAITS[name]


def key_bits(dtype) -> int:
    return traits_for(dtype).bits


# ---------------------------------------------------------------------------
# 32-bit plane twiddles
# ---------------------------------------------------------------------------


def _twiddle32_in(u: jax.Array, traits: KeyTraits) -> jax.Array:
    """Map a 32-bit bit pattern to its order-preserving unsigned image."""
    if traits.is_float:
        sign = u >> jnp.uint32(31)
        mask = jnp.where(sign == 1, jnp.uint32(0xFFFFFFFF), jnp.uint32(0x80000000))
        return u ^ mask
    if traits.is_signed:
        return u ^ jnp.uint32(0x80000000)
    return u


def _twiddle32_out(t: jax.Array, traits: KeyTraits) -> jax.Array:
    if traits.is_float:
        # after twiddle-in, originally-negative values have sign bit 0
        sign = t >> jnp.uint32(31)
        mask = jnp.where(sign == 1, jnp.uint32(0x80000000), jnp.uint32(0xFFFFFFFF))
        return t ^ mask
    if traits.is_signed:
        return t ^ jnp.uint32(0x80000000)
    return t


# ---------------------------------------------------------------------------
# 64-bit keys as (hi, lo) uint32 planes
# ---------------------------------------------------------------------------


def split64(keys: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Split a 64-bit array into (hi, lo) uint32 planes.

    Requires ``jax_enable_x64`` only at the boundary; everything downstream
    is pure 32-bit.
    """
    u = keys.view(jnp.uint64) if keys.dtype != jnp.uint64 else keys
    hi = (u >> jnp.uint64(32)).astype(jnp.uint32)
    lo = (u & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    return hi, lo


def join64(hi: jax.Array, lo: jax.Array, dtype=jnp.uint64) -> jax.Array:
    u = (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)
    if jnp.dtype(dtype) == jnp.uint64:
        return u
    return u.view(dtype)


def split64_host(keys) -> Tuple["np.ndarray", "np.ndarray"]:
    """HOST-side (hi, lo) uint32 planes from any 64-bit array-like.

    Unlike :func:`split64` this never touches jax (no ``jax_enable_x64``
    needed): it is the public-API boundary when x64 is off and JAX holds
    no 64-bit arrays.  The bitcast view covers every
    64-bit key dtype of the reference's ``Traits``
    (``lsb/cub/cub/util_type.cuh:1104-1130``)."""
    import numpy as np

    a = np.ascontiguousarray(np.asarray(keys))
    if a.dtype.itemsize != 8:
        raise ValueError(f"split64_host expects a 64-bit dtype, got {a.dtype}")
    u = a.view(np.uint64)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def join64_host(hi, lo, dtype="uint64") -> "np.ndarray":
    """HOST-side inverse of :func:`split64_host` (returns numpy)."""
    import numpy as np

    u = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo).astype(np.uint64)
    return u.view(np.dtype(dtype))


# ---------------------------------------------------------------------------
# Public twiddle API (plane-based)
# ---------------------------------------------------------------------------


def twiddle_planes_in(
    planes: Tuple[jax.Array, ...], traits: KeyTraits, *,
    descending: bool = False,
) -> Tuple[jax.Array, ...]:
    """Twiddle raw uint32 bit-pattern plane(s) of a key (plane 0 = most
    significant word) into sortable-unsigned planes.  This is the plane
    64-bit entry: 64-bit keys never exist as 64-bit arrays, only as
    (hi, lo) uint32 planes."""
    if traits.planes == 1:
        (u,) = planes
        t = _twiddle32_in(u, traits)
        return (~t,) if descending else (t,)
    hi, lo = planes
    if traits.is_float:
        sign = hi >> jnp.uint32(31)
        hi_mask = jnp.where(sign == 1, jnp.uint32(0xFFFFFFFF), jnp.uint32(0x80000000))
        lo_mask = jnp.where(sign == 1, jnp.uint32(0xFFFFFFFF), jnp.uint32(0))
        hi, lo = hi ^ hi_mask, lo ^ lo_mask
    elif traits.is_signed:
        hi = hi ^ jnp.uint32(0x80000000)
    if descending:
        hi, lo = ~hi, ~lo
    return (hi, lo)


def twiddle_planes_out(
    planes: Tuple[jax.Array, ...], traits: KeyTraits, *,
    descending: bool = False,
) -> Tuple[jax.Array, ...]:
    """Inverse of :func:`twiddle_planes_in` (returns raw bit-pattern
    planes)."""
    if traits.planes == 1:
        (t,) = planes
        if descending:
            t = ~t
        return (_twiddle32_out(t, traits),)
    hi, lo = planes
    if descending:
        hi, lo = ~hi, ~lo
    if traits.is_float:
        sign = hi >> jnp.uint32(31)
        hi_mask = jnp.where(sign == 1, jnp.uint32(0x80000000), jnp.uint32(0xFFFFFFFF))
        lo_mask = jnp.where(sign == 1, jnp.uint32(0), jnp.uint32(0xFFFFFFFF))
        hi, lo = hi ^ hi_mask, lo ^ lo_mask
    elif traits.is_signed:
        hi = hi ^ jnp.uint32(0x80000000)
    return (hi, lo)


def twiddle_in(
    keys: jax.Array, *, descending: bool = False
) -> Tuple[Tuple[jax.Array, ...], KeyTraits]:
    """Map keys to uint32 plane(s) whose ascending unsigned order equals the
    requested key order.

    Returns ``((hi, lo) | (plane,), traits)``.  Planes are uint32; for 64-bit
    keys plane 0 is the most-significant word.
    """
    traits = traits_for(keys.dtype)
    if traits.planes == 1:
        u = keys.view(jnp.uint32) if keys.dtype != jnp.uint32 else keys
        return twiddle_planes_in((u,), traits, descending=descending), traits
    raw = split64(keys)
    return twiddle_planes_in(raw, traits, descending=descending), traits


def twiddle_out(
    planes: Tuple[jax.Array, ...],
    traits: KeyTraits,
    *,
    descending: bool = False,
    dtype=None,
) -> jax.Array:
    """Inverse of :func:`twiddle_in`; reassembles keys of ``dtype``."""
    if dtype is None:
        dtype = traits.name
    raw = twiddle_planes_out(planes, traits, descending=descending)
    if traits.planes == 1:
        (u,) = raw
        return u.view(dtype) if jnp.dtype(dtype) != jnp.uint32 else u
    return join64(raw[0], raw[1], dtype=dtype)
