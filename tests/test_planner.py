"""Host-side tier pre-classifier tests (tpusort.planner).

The reference's CPU planner analog: predict, from a strided sample,
whether the radix tier's static capacities would overflow."""

import numpy as np
import pytest

from tpusort import planner
from tpusort.ops.msd import plan_msd

PLAN = plan_msd(1 << 26, 0, 32)
N = 1 << 26


def _sample(arr):
    stride = max(1, arr.size // planner.SAMPLE_TARGET)
    return arr[::stride]


def test_uniform_not_flagged():
    rng = np.random.default_rng(0)
    s = rng.integers(0, 1 << 32, planner.SAMPLE_TARGET,
                     dtype=np.int64).astype(np.uint32)
    assert not planner.predict_radix_overflow(s, PLAN, N)


def test_constant_flagged():
    s = np.full(planner.SAMPLE_TARGET, 12345, np.uint32)
    assert planner.predict_radix_overflow(s, PLAN, N)


def test_entropy_and_flagged():
    """AND of 4 uniform draws: top digits heavily biased toward 0."""
    rng = np.random.default_rng(1)
    draws = rng.integers(0, 1 << 32, (4, planner.SAMPLE_TARGET),
                         dtype=np.int64).astype(np.uint32)
    s = draws[0] & draws[1] & draws[2] & draws[3]
    assert planner.predict_radix_overflow(s, PLAN, N)


def test_zipf_flagged():
    rng = np.random.default_rng(2)
    z = rng.zipf(1.2, planner.SAMPLE_TARGET).astype(np.uint32)
    assert planner.predict_radix_overflow(z, PLAN, N)


def test_presorted_flagged_by_sortedness():
    rng = np.random.default_rng(3)
    s = np.sort(rng.integers(0, 1 << 32, planner.SAMPLE_TARGET,
                             dtype=np.int64).astype(np.uint32))
    assert planner.sortedness(s) > 0.99
    assert planner.predict_radix_overflow(s, PLAN, N)


def test_tiny_sample_never_flags():
    s = np.zeros(100, np.uint32)
    assert not planner.predict_radix_overflow(s, PLAN, N)


def test_leaf_profile_keys_plan_selection():
    """The GetSortKernel analog (gpu_sort_config.h:250-264): the cost
    model keys the leaf on its remaining bit width, so the plan keeps
    rem_width + idx_bits + 1 <= 32 (the packed-sortkey leaf's word
    budget) by preferring an extra pass over the ~5x multikey leaf."""
    from tpusort.ops.msd import plan_msd

    n = 1 << 24
    packed = plan_msd(n, 0, 32)
    assert packed is not None
    assert len(packed.passes) == 3

    def idx_bits(seg):
        b = (seg - 1).bit_length()
        return b + (1 if seg >= (1 << b) else 0)

    assert packed.rem_width + idx_bits(packed.seg) + 1 <= 32


def test_reverse_sorted_flagged():
    """Reverse-sorted inputs concentrate tiles exactly like ascending
    ones; the sortedness signal must be direction-blind."""
    rng = np.random.default_rng(4)
    s = np.sort(rng.integers(0, 1 << 32, planner.SAMPLE_TARGET,
                             dtype=np.int64).astype(np.uint32))[::-1]
    assert planner.sortedness(s) > 0.99
    assert planner.predict_radix_overflow(s.copy(), PLAN, N)


def test_big_tile_low_alpha_plan():
    """Big-tile low-alpha geometry: k=65536 / s1=2560 (alpha 1.25; the
    6.5-sigma capacity holds at big-tile binomial noise) / s=2048 (pow2
    merge granule) must plan at 2^28 with every pass on whole tiles and a
    leaf that fits the packed sortkey word."""
    p = plan_msd(1 << 28, 0, 32, k=1 << 16, s1=2560, leaf_max=327680)
    assert p is not None
    assert len(p.passes) == 3
    assert p.passes[0].s == 2560
    assert all(sp.s == 2048 for sp in p.passes[1:])
    assert all(sp.k == 1 << 16 for sp in p.passes)
    assert p.seg == 10240 and p.m_final == (1 << 28) * 5 // 4
    idx_bits = (p.seg - 1).bit_length()
    assert p.rem_width + idx_bits + 1 <= 32
