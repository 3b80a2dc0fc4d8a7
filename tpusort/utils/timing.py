"""Device timing utilities.

The analog of the reference's timer layer (``lsb/gpu_utils.h:3-11``
SETUP_TIMING/TIME_FUNC cudaEvent macros; ``msb/external/benchmark/
get_real_time.cu`` wall clock): the host clock around calls that end in
``jax.block_until_ready``, reported as the median of the timed runs.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, List

import jax

__all__ = ["measure", "measure_all"]


def measure_all(fn: Callable, *args, iters: int = 5,
                warmup: int = 1) -> List[float]:
    """Wall times in seconds of ``iters`` calls of ``fn(*args)``, each
    waited on with ``block_until_ready``, after ``warmup`` untimed calls
    (the first of which compiles).

    ``fn`` is called as given: pass a jitted function to time a traced
    step, or a public API function to time its host-side control flow
    (the tier chain, the sample classifier) as well."""
    for _ in range(max(warmup, 1)):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times


def measure(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Median of :func:`measure_all`, in seconds."""
    return statistics.median(measure_all(fn, *args, iters=iters,
                                         warmup=warmup))
