"""tpusort — a vectorized sort engine in JAX, run on NVIDIA GPUs.

Built from scratch with the capabilities of the CUDA reference
``anilshanbhag/gpu-sort``: stable LSD radix sort, bandwidth-efficient hybrid
MSD radix sort, bitonic/sorting-network small-tile sorts, key-value pairs,
ascending/descending, bit-range sub-sorts, 32/64-bit integer and float keys —
plus a distributed multi-host global sort the reference never had.
"""

from tpusort.api import (
    argsort,
    available_engines,
    register_engine,
    sort,
    sort_keys,
    sort_keys_descending,
    sort_pairs,
    sort_pairs_descending,
    sort_pairs_lsb_in_value,
    sort_planes,
    unstable_sort_keys,
    unstable_sort_pairs,
)
from tpusort.configs import SortConfig, get_config, register_config
from tpusort.ops.segmented import segmented_sort, sort_batched

__version__ = "0.1.0"
