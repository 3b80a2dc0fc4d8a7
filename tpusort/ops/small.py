"""Small-array engine ("bitonic"): one unstable sort, no passes.

Analog of CUB's single-tile dispatch (``DeviceRadixSortSingleTileKernel`` /
``InvokeSingleTile``, ``dispatch_radix_sort.cuh:209,834-875``: one block
sorts everything) and the surfacing of the reference's sorting networks
(``msb/src/sort/sorting_network.cuh``) as a standalone capability: a
problem of at most ``config.small_n_threshold`` keys is finished by one
unstable ``lax.sort``, with no passes, histograms or exchanges.

Unstable (no position tiebreak); exact for keys, permutation-equivalent
for pairs.  The engine delegates to the stable reference path for larger
problems and for bit-range subsorts.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax

from tpusort.ops.reference import sort_twiddled_reference

_MAX_SINGLE_TILE = 1 << 14


def sort_twiddled_bitonic(
    planes: Tuple[jax.Array, ...],
    values: Sequence[jax.Array],
    *,
    begin_bit: int,
    end_bit: int,
    total_bits: int,
    config=None,
):
    n = planes[0].shape[0]
    tile_max = min(
        config.small_n_threshold if config is not None else _MAX_SINGLE_TILE,
        _MAX_SINGLE_TILE,
    )
    if begin_bit != 0 or end_bit != total_bits or n > tile_max:
        return sort_twiddled_reference(
            planes, values, begin_bit=begin_bit, end_bit=end_bit,
            total_bits=total_bits,
        )
    out = jax.lax.sort(list(planes) + list(values), num_keys=len(planes),
                       is_stable=False)
    return tuple(out[:len(planes)]), tuple(out[len(planes):])
