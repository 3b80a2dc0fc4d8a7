"""Segmented (batched) sort — the ``DeviceSegmentedRadixSort`` analog
(``lsb/cub/cub/device/device_segmented_radix_sort.cuh``, SURVEY.md L-2/L-10).

Two paths, both one ``lax.sort``:

* **uniform segments** (shape (B, K)): a batched sort along the rows;
* **ragged segments** (offsets array): a composite sort by
  (segment_id, key).

Bit-range sub-sorts (``begin_bit``/``end_bit`` — the CUB parameters every
``DeviceSegmentedRadixSort`` entry point carries) compare only the masked
key window while the full keys ride as payload, preserving CUB's stable
tie semantics for the untouched bits.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp

from tpusort import dtypes as _dtypes

__all__ = ["segmented_sort", "sort_batched"]


def _masked_planes(planes, traits, begin_bit: int, end_bit: Optional[int]):
    """(comparison planes, is_full_range): masked to [begin_bit, end_bit)
    when a proper sub-range is requested (CUB's bit-window comparison,
    ``device_segmented_radix_sort.cuh`` SortPairs/SortKeys overloads)."""
    eb = traits.bits if end_bit is None else end_bit
    if not (0 <= begin_bit < eb <= traits.bits):
        raise ValueError(
            f"invalid bit range [{begin_bit}, {eb}) for {traits.name}"
        )
    if begin_bit == 0 and eb == traits.bits:
        return planes, True
    from tpusort.ops.reference import _mask_plane_bits

    return _mask_plane_bits(tuple(planes), begin_bit, eb, traits.bits), False


def sort_batched(
    keys: jax.Array,
    values=None,
    *,
    descending: bool = False,
    begin_bit: int = 0,
    end_bit: Optional[int] = None,
    stable: bool = False,
):
    """Sort each row of (B, K) keys independently (uniform segments)."""
    b, k = keys.shape
    planes, traits = _dtypes.twiddle_in(keys.reshape(-1), descending=descending)
    vt, single = _normalize(values)
    vops = [jnp.asarray(v).view(jnp.uint32).reshape(b, k) for v in vt]
    cmp_planes, full_range = _masked_planes(planes, traits, begin_bit,
                                            end_bit)

    if full_range:
        key_ops = [p.reshape(b, k) for p in planes]
        res = jax.lax.sort(key_ops + vops, dimension=1,
                           num_keys=len(key_ops), is_stable=stable)
        sorted_planes = tuple(r.reshape(-1) for r in res[: len(key_ops)])
        sorted_vals = list(res[len(key_ops):])
    else:
        # bit-window comparison: sort by the masked planes, carry the full
        # planes as payload; STABLE so equal-window keys keep input order
        # (CUB's sub-range semantics for the untouched bits)
        cmp_ops = [p.reshape(b, k) for p in cmp_planes]
        carry = [p.reshape(b, k) for p in planes]
        res = jax.lax.sort(cmp_ops + carry + vops, dimension=1,
                           num_keys=len(cmp_ops), is_stable=True)
        nc = len(cmp_ops)
        sorted_planes = tuple(
            r.reshape(-1) for r in res[nc : nc + len(planes)]
        )
        sorted_vals = list(res[nc + len(planes):])

    out_keys = _dtypes.twiddle_out(
        sorted_planes, traits, descending=descending, dtype=keys.dtype
    ).reshape(b, k)
    if values is None:
        return out_keys
    outs = tuple(
        o.reshape(b, k).view(jnp.asarray(v).dtype)
        for o, v in zip(sorted_vals, vt)
    )
    return out_keys, (outs[0] if single else outs)


def segmented_sort(
    keys: jax.Array,
    segment_offsets: jax.Array,
    values=None,
    *,
    descending: bool = False,
    begin_bit: int = 0,
    end_bit: Optional[int] = None,
    stable: bool = True,
):
    """Sort within ragged segments (stable by default, CUB semantics).

    segment_offsets: (num_segments + 1,) int array of segment boundaries
    (CUB's begin/end offset convention, device_segmented_radix_sort.cuh),
    covering [0, n): offsets[0] == 0, offsets[-1] == n, non-decreasing.
    Uncovered elements have no defined destination in the boundary
    convention (the composite seg_id would wrap/collide), so non-covering
    concrete offsets are rejected rather than silently corrupting segments.

    ``begin_bit``/``end_bit`` compare only that key-bit window (parity
    with every ``DeviceSegmentedRadixSort`` entry point); ``stable=False``
    permits reordering of equal-key payloads.
    """
    n = keys.shape[0]
    if not isinstance(segment_offsets, jax.core.Tracer):
        import numpy as np

        so = np.asarray(segment_offsets)
        if (so.ndim != 1 or so.shape[0] < 2 or so[0] != 0 or so[-1] != n
                or np.any(np.diff(so.astype(np.int64)) < 0)):
            raise ValueError(
                "segment_offsets must be a non-decreasing (num_segments+1,)"
                f" array covering [0, {n}) (got first={so.flat[0] if so.size else '?'},"
                f" last={so.flat[-1] if so.size else '?'})"
            )
    planes, traits = _dtypes.twiddle_in(keys, descending=descending)
    vt, single = _normalize(values)
    cmp_planes, full_range = _masked_planes(planes, traits, begin_bit,
                                            end_bit)

    pos = jnp.arange(n, dtype=jnp.int32)
    seg_id = (
        jnp.searchsorted(segment_offsets.astype(jnp.int32), pos, side="right")
        - 1
    ).astype(jnp.uint32)

    if full_range:
        operands = [seg_id] + list(planes) + [jnp.asarray(v) for v in vt]
        res = jax.lax.sort(operands, num_keys=1 + len(planes),
                           is_stable=True)
        sorted_planes = tuple(res[1 : 1 + len(planes)])
        tail = res[1 + len(planes):]
    else:
        # bit-window comparison with the full planes carried as payload
        operands = (
            [seg_id] + list(cmp_planes) + list(planes)
            + [jnp.asarray(v) for v in vt]
        )
        res = jax.lax.sort(operands, num_keys=1 + len(cmp_planes),
                           is_stable=True)
        nc = 1 + len(cmp_planes)
        sorted_planes = tuple(res[nc : nc + len(planes)])
        tail = res[nc + len(planes):]
    out_keys = _dtypes.twiddle_out(
        sorted_planes, traits, descending=descending, dtype=keys.dtype
    )
    if values is None:
        return out_keys
    outs = tuple(tail)
    return out_keys, (outs[0] if single else outs)


def _normalize(values) -> Tuple[Tuple[jax.Array, ...], bool]:
    if values is None:
        return (), False
    if isinstance(values, (tuple, list)):
        return tuple(values), False
    return (values,), True
