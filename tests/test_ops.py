"""Tests for the query-kernel-library ops: scan, histogram, segmented sort,
single-tile bitonic fast path (SURVEY.md L-10 subset + L-2 segmented)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpusort
from tpusort.ops import histogram as th
from tpusort.ops import scan as ts
from tpusort.ops import segmented as tseg
from tpusort.utils import datagen
from oracle import np_sort_oracle


def test_inclusive_exclusive_sum():
    x = jnp.asarray(np.random.default_rng(0).integers(0, 100, 1000))
    np.testing.assert_array_equal(np.asarray(ts.inclusive_sum(x)),
                                  np.cumsum(np.asarray(x)))
    np.testing.assert_array_equal(
        np.asarray(ts.exclusive_sum(x)),
        np.cumsum(np.asarray(x)) - np.asarray(x))


def test_generic_scans():
    x = jnp.asarray(np.random.default_rng(1).integers(0, 1000, 512))
    got = ts.inclusive_scan(x, jnp.maximum)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.maximum.accumulate(np.asarray(x)))
    got = ts.exclusive_scan(x, jnp.maximum, identity=0)
    want = np.roll(np.maximum.accumulate(np.asarray(x)), 1)
    want[0] = 0
    np.testing.assert_array_equal(np.asarray(got), want)


def test_segmented_sum():
    rng = np.random.default_rng(2)
    x = rng.random(2000).astype(np.float32)
    ids = rng.integers(0, 16, 2000)
    got = ts.segmented_sum(jnp.asarray(x), jnp.asarray(ids), 16)
    want = np.array([x[ids == s].sum() for s in range(16)], np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5)


def test_histogram_even():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1000, 5000).astype(np.int32)
    got = th.histogram_even(jnp.asarray(x), 10, 0, 1000)
    want, _ = np.histogram(x, bins=10, range=(0, 1000))
    np.testing.assert_array_equal(np.asarray(got), want)
    # out-of-range values are dropped
    x2 = np.concatenate([x, np.array([-5, 1000, 2000], np.int32)])
    got2 = th.histogram_even(jnp.asarray(x2), 10, 0, 1000)
    np.testing.assert_array_equal(np.asarray(got2), want)


def test_histogram_even_wide_range_exact():
    """Full-range u32 binning must be boundary-exact (a float32 divide
    misbins keys above 2^24)."""
    lo, hi, bins = 0, 1 << 32, 7
    # exact edges: ceil(j * 2^32 / 7); place values straddling each edge
    edges = [-(-(j * (1 << 32)) // bins) for j in range(bins + 1)]
    vals = []
    for e in edges[1:bins]:
        vals += [e - 1, e, e + 1]
    vals += [0, (1 << 32) - 1, (1 << 31), (1 << 24) + 1, (1 << 24) - 1]
    x = np.array(vals, np.uint32)
    got = np.asarray(th.histogram_even(jnp.asarray(x), bins, lo, hi))
    want = np.zeros(bins, np.int64)
    for v in vals:
        for j in range(bins):
            if edges[j] <= v < edges[j + 1]:
                want[j] += 1
    np.testing.assert_array_equal(got, want)
    # int32 negative range + non-representable float edges
    xi = np.array([-100, -1, 0, 1, 99, 100, 101], np.int32)
    got3 = np.asarray(th.histogram_even(jnp.asarray(xi), 3, -100, 101))
    want3, _ = np.histogram(xi[xi < 101], bins=3, range=(-100, 101))
    np.testing.assert_array_equal(got3, want3)
    # float32 keys with a fractional edge
    xf = np.array([0.0, 0.5, 1.0 / 3, 2.0 / 3, 0.999], np.float32)
    got4 = np.asarray(th.histogram_even(jnp.asarray(xf), 3, 0.0, 1.0))
    want4, _ = np.histogram(xf, bins=3, range=(0.0, 1.0))
    np.testing.assert_array_equal(got4, want4)


def test_digit_histogram():
    keys = datagen.random_keys(jax.random.key(0), 4096, "uint32")
    got = th.digit_histogram(keys, shift=8, bits=8, tiles=4)
    k = np.asarray(keys).reshape(4, 1024)
    want = np.stack([
        np.bincount((row >> 8) & 0xFF, minlength=256) for row in k
    ])
    np.testing.assert_array_equal(np.asarray(got), want)


def test_sort_batched_uniform():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 2**32, (16, 512), dtype=np.uint32)
    vals = np.arange(16 * 512, dtype=np.uint32).reshape(16, 512)
    gk, gv = tseg.sort_batched(jnp.asarray(keys), jnp.asarray(vals),
                               stable=True)
    order = np.argsort(keys, axis=1, kind="stable")
    np.testing.assert_array_equal(np.asarray(gk),
                                  np.take_along_axis(keys, order, 1))
    np.testing.assert_array_equal(np.asarray(gv),
                                  np.take_along_axis(vals, order, 1))


def test_sort_batched_float_desc():
    rng = np.random.default_rng(5)
    keys = rng.standard_normal((8, 256)).astype(np.float32)
    gk = tseg.sort_batched(jnp.asarray(keys), descending=True)
    np.testing.assert_array_equal(np.asarray(gk), -np.sort(-keys, axis=1))


def test_segmented_sort_ragged():
    rng = np.random.default_rng(6)
    n = 5000
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    offs = np.array([0, 17, 17, 1000, 2500, n])
    gk, gv = tseg.segmented_sort(jnp.asarray(keys), jnp.asarray(offs),
                                 jnp.asarray(vals))
    gk, gv = np.asarray(gk), np.asarray(gv)
    for s in range(len(offs) - 1):
        lo, hi = offs[s], offs[s + 1]
        order = np.argsort(keys[lo:hi], kind="stable")
        np.testing.assert_array_equal(gk[lo:hi], keys[lo:hi][order])
        np.testing.assert_array_equal(gv[lo:hi], vals[lo:hi][order])


def test_segmented_sort_bit_range():
    """begin_bit/end_bit on every entry point (parity with CUB\'s
    DeviceSegmentedRadixSort overloads): only the masked window is
    compared; equal-window keys keep input order (stable)."""
    rng = np.random.default_rng(16)
    n = 3000
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    offs = np.array([0, 700, 700, 2000, n])
    gk, gv = tseg.segmented_sort(jnp.asarray(keys), jnp.asarray(offs),
                                 jnp.asarray(vals), begin_bit=8, end_bit=24)
    gk, gv = np.asarray(gk), np.asarray(gv)
    win = (keys >> np.uint32(8)) & np.uint32(0xFFFF)
    for s in range(len(offs) - 1):
        lo, hi = offs[s], offs[s + 1]
        order = np.argsort(win[lo:hi], kind="stable")
        np.testing.assert_array_equal(gk[lo:hi], keys[lo:hi][order])
        np.testing.assert_array_equal(gv[lo:hi], vals[lo:hi][order])


def test_segmented_sort_ragged_pairs_unstable():
    """stable=False ragged pairs: per-segment key order + pair binding
    must hold even if equal-key payload order may differ."""
    rng = np.random.default_rng(17)
    n = 4000
    keys = rng.integers(0, 256, n, dtype=np.uint32)  # heavy ties
    vals = np.arange(n, dtype=np.uint32)
    offs = np.array([0, 1024, 2048, n])
    gk, gv = tseg.segmented_sort(jnp.asarray(keys), jnp.asarray(offs),
                                 jnp.asarray(vals), stable=False)
    gk, gv = np.asarray(gk), np.asarray(gv)
    for s in range(len(offs) - 1):
        lo, hi = offs[s], offs[s + 1]
        np.testing.assert_array_equal(gk[lo:hi],
                                      np.sort(keys[lo:hi], kind="stable"))
        # binding: every output pair maps back to its original key
        np.testing.assert_array_equal(keys[gv[lo:hi]], gk[lo:hi])
        assert set(gv[lo:hi].tolist()) == set(range(lo, hi))


def test_segmented_sort_descending_pairs():
    rng = np.random.default_rng(18)
    n = 2500
    keys = rng.standard_normal(n).astype(np.float32)
    vals = np.arange(n, dtype=np.uint32)
    offs = np.array([0, 500, 1700, n])
    gk, gv = tseg.segmented_sort(jnp.asarray(keys), jnp.asarray(offs),
                                 jnp.asarray(vals), descending=True)
    gk, gv = np.asarray(gk), np.asarray(gv)
    for s in range(len(offs) - 1):
        lo, hi = offs[s], offs[s + 1]
        order = np.argsort(-keys[lo:hi], kind="stable")
        np.testing.assert_array_equal(gk[lo:hi], keys[lo:hi][order])
        np.testing.assert_array_equal(gv[lo:hi], vals[lo:hi][order])


def test_sort_batched_bit_range():
    rng = np.random.default_rng(19)
    keys = rng.integers(0, 2**32, (8, 384), dtype=np.uint32)
    vals = np.arange(8 * 384, dtype=np.uint32).reshape(8, 384)
    gk, gv = tseg.sort_batched(jnp.asarray(keys), jnp.asarray(vals),
                               begin_bit=4, end_bit=20)
    win = (keys >> np.uint32(4)) & np.uint32(0xFFFF)
    order = np.argsort(win, axis=1, kind="stable")
    np.testing.assert_array_equal(np.asarray(gk),
                                  np.take_along_axis(keys, order, 1))
    np.testing.assert_array_equal(np.asarray(gv),
                                  np.take_along_axis(vals, order, 1))


@pytest.mark.parametrize("n", [100, 1000, 12288, 16384])
def test_bitonic_engine_small_n(n):
    keys = datagen.random_keys(jax.random.key(n), n, "uint32")
    got = tpusort.sort(keys, algorithm="bitonic")
    np.testing.assert_array_equal(np.asarray(got),
                                  np_sort_oracle(np.asarray(keys)))


def test_bitonic_engine_pairs_permutation():
    n = 1024  # multiple of 128: kernel path with payloads
    keys = datagen.entropy_keys(jax.random.key(7), n, 2, "uint32")
    vals = datagen.enumerated_values(n)
    gk, gv = tpusort.sort(keys, vals, algorithm="bitonic")
    gk, gv = np.asarray(gk), np.asarray(gv)
    np.testing.assert_array_equal(gk, np_sort_oracle(np.asarray(keys)))
    assert int(gv.astype(np.uint64).sum()) == n * (n - 1) // 2
    np.testing.assert_array_equal(np.asarray(keys)[gv], gk)


def test_log_module():
    """M-12 analog: leveled logger + timer context."""
    import logging
    from tpusort.utils import log as tlog
    tlog.set_level("TRACE")
    with tlog.timed("unit-test block", level=logging.INFO):
        pass
    tlog.set_level("WARNING")


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
@pytest.mark.parametrize("exclusive", [False, True])
def test_prefix_sum_pallas_kernel(dtype, exclusive):
    """ops.scan's 1-D sums (CUB DeviceScan analog) must match np.cumsum
    exactly across ragged lengths."""
    rng = np.random.default_rng(7)
    for n in [1, 128 * 8, 128 * 8 * 3 + 77]:
        if dtype == np.float32:
            x = rng.integers(0, 1 << 10, n).astype(np.float32)
        else:
            x = rng.integers(0, 1 << 20, n).astype(dtype)
        fn = ts.exclusive_sum if exclusive else ts.inclusive_sum
        got = np.asarray(fn(jnp.asarray(x)))
        want = np.cumsum(x, dtype=dtype)
        if exclusive:
            want = want - x
        np.testing.assert_array_equal(got, want)


def test_scan_ops_pallas_route():
    """ops.scan's public 1-D sums on an int32 input."""
    x = jnp.asarray(np.arange(128 * 8 * 2, dtype=np.int32))
    got = ts.inclusive_sum(x)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.cumsum(np.asarray(x)))
    got = ts.exclusive_sum(x)
    np.testing.assert_array_equal(
        np.asarray(got), np.cumsum(np.asarray(x)) - np.asarray(x))


def test_digit_histogram_pallas_kernel():
    """The global (tiles == 1) digit histogram must match np.bincount."""
    rng = np.random.default_rng(11)
    n = 128 * 8 * 4
    x = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    for shift, bits in [(27, 5), (0, 3), (24, 8)]:
        got = np.asarray(th.digit_histogram(jnp.asarray(x), shift, bits))
        want = np.bincount((x >> shift) & ((1 << bits) - 1),
                           minlength=1 << bits).astype(np.int32)
        np.testing.assert_array_equal(got[0], want)


def test_segmented_sort_rejects_noncovering_offsets():
    """Boundary-convention offsets must cover [0, n): uncovered elements
    would wrap/collide in the composite seg_id (regression)."""
    keys = jnp.arange(1024, dtype=jnp.uint32)[::-1].copy()
    for bad in ([0, 256, 512], [16, 256, 1024], [0, 700, 600, 1024]):
        with pytest.raises(ValueError):
            tseg.segmented_sort(keys, jnp.asarray(np.array(bad)))
