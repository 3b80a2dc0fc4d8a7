"""Reference sort engine: semantically exact, used as the in-framework oracle.

This is the analog of the CUDA reference's use of CUB ``DeviceRadixSort`` as
the trusted oracle in its tests (``msb/tests/test_sort_keys.cu:14-45``): a
slow-but-certain implementation every fast engine is checked against.  It is
built on XLA's stable variadic sort, so it runs on CPU and GPU alike.

Semantics implemented (mirroring ``cub::DeviceRadixSort``,
``lsb/cub/cub/device/device_radix_sort.cuh:147-660``):
  * stable keys / key-value sort, ascending or descending,
  * ``begin_bit``/``end_bit`` sub-range sorts (bits outside the range do not
    participate in the comparison; stability preserves input order among
    keys equal on the selected bits).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from tpusort.dtypes import KeyTraits


def _mask_plane_bits(
    planes: Tuple[jax.Array, ...], begin_bit: int, end_bit: int, total_bits: int
) -> Tuple[jax.Array, ...]:
    """Zero out bits outside [begin_bit, end_bit) across the plane stack.

    Plane 0 holds the most-significant 32 bits.
    """
    if begin_bit == 0 and end_bit == total_bits:
        return planes
    out = []
    nplanes = len(planes)
    for i, p in enumerate(planes):
        # bit range covered by this plane in global key-bit coordinates
        plane_lo = 32 * (nplanes - 1 - i)
        lo = max(begin_bit - plane_lo, 0)
        hi = min(end_bit - plane_lo, 32)
        if hi <= lo:
            out.append(jnp.zeros_like(p))
            continue
        mask = ((1 << hi) - 1) & ~((1 << lo) - 1) & 0xFFFFFFFF
        out.append(p & jnp.uint32(mask))
    return tuple(out)


def sort_twiddled_reference(
    planes: Tuple[jax.Array, ...],
    values: Sequence[jax.Array],
    *,
    begin_bit: int,
    end_bit: int,
    total_bits: int,
    config=None,
) -> Tuple[Tuple[jax.Array, ...], Tuple[jax.Array, ...]]:
    """Stable ascending sort of twiddled uint32 plane(s) + payloads.

    ``config`` is accepted for engine-registry signature parity and ignored
    (the XLA sort has no tunables)."""
    operands = list(_mask_plane_bits(planes, begin_bit, end_bit, total_bits))
    # carry the original (unmasked) planes and all payloads through the sort
    carried = list(planes) + list(values)
    result = jax.lax.sort(
        operands + carried, dimension=0, num_keys=len(operands), is_stable=True
    )
    sorted_planes = tuple(result[len(operands) : len(operands) + len(planes)])
    sorted_values = tuple(result[len(operands) + len(planes) :])
    return sorted_planes, sorted_values
