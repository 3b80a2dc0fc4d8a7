"""In-graph verification of a sort's output against its input.

Checks a large result on the device without copying it to the host:
lexicographic sortedness, key-multiset fingerprints, a (key, value)
binding fingerprint and, for enumerated payloads, stability.  uint32 sums
wrap mod 2^32 on both sides, so the fingerprints compare exactly.
"""

from __future__ import annotations

from typing import Sequence, Union

import jax
import jax.numpy as jnp

__all__ = ["sort_checks"]

Planes = Union[jax.Array, Sequence[jax.Array]]


def _mix(x):
    """splitmix32 finalizer: order-independent multiset fingerprint."""
    x = (x ^ (x >> jnp.uint32(16))) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> jnp.uint32(15))) * jnp.uint32(0x846CA68B)
    return x ^ (x >> jnp.uint32(16))


def _as_planes(a: Planes):
    planes = tuple(a) if isinstance(a, (tuple, list)) else (a,)
    return tuple(jnp.asarray(p).view(jnp.uint32) for p in planes)


def _row_fingerprint(planes):
    fp = _mix(planes[0])
    for p in planes[1:]:
        fp = _mix(p ^ _mix(fp))
    return fp


def _usum(x):
    return jnp.sum(x, dtype=jnp.uint32)


def sort_checks(out_keys: Planes, in_keys: Planes, out_vals=None,
                in_vals=None, *, stable: bool = False) -> jax.Array:
    """Scalar bool: True iff ``out_keys`` (uint32 planes, plane 0 most
    significant, ascending) is a sorted permutation of ``in_keys`` carrying
    the same (key, value) pairs.  With ``stable``, ``in_vals`` must be the
    enumeration 0..n-1, and equal keys must keep ascending values."""
    ko, ki = _as_planes(out_keys), _as_planes(in_keys)
    lt = jnp.zeros(ko[0].shape[0] - 1, bool)
    eq = jnp.ones(ko[0].shape[0] - 1, bool)
    for p in ko:
        lt = lt | (eq & (p[:-1] < p[1:]))
        eq = eq & (p[:-1] == p[1:])
    ok = jnp.all(lt | eq)
    fo, fi = _row_fingerprint(ko), _row_fingerprint(ki)
    ok &= _usum(fo) == _usum(fi)
    for po, pi in zip(ko, ki):
        ok &= _usum(po) == _usum(pi)
    if out_vals is not None:
        vo, vi = _as_planes(out_vals), _as_planes(in_vals)
        for a, b in zip(vo, vi):
            ok &= _usum(_mix(fo ^ _mix(a))) == _usum(_mix(fi ^ _mix(b)))
        if stable:
            ok &= jnp.all(~eq | (vo[0][1:] > vo[0][:-1]))
    return ok
