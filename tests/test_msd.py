"""MSD hybrid engine tests (small geometry, CPU).

Mirrors the reference's MSB test matrix (``msb/tests/test_sort_keys.cu``,
``test_sort_pairs.cu``): oracle comparison across types x entropies x sizes,
plus pair stability, bit-range sub-sorts, and the skew/overflow fallback.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpusort
from tpusort import dtypes as td
from tpusort.ops import msd
from tpusort.utils import datagen
from oracle import np_sort_oracle

# small geometry so tests run fast and exercise multiple passes
SMALL = dict(k=2048, r=8, s1=384, s=256, leaf_max=2048, min_n=1)


def _msd_sort(keys, values=None, *, descending=False, begin_bit=0,
              end_bit=None, plan_kwargs=SMALL):
    """Direct engine invocation with small-geometry plan overrides."""
    planes, traits = td.twiddle_in(keys, descending=descending)
    eb = traits.bits if end_bit is None else end_bit
    vt = () if values is None else (values,)
    sp, sv = msd.sort_twiddled_msd(
        planes, vt, begin_bit=begin_bit, end_bit=eb, total_bits=traits.bits,
        plan_kwargs=plan_kwargs,
    )
    out = td.twiddle_out(sp, traits, descending=descending, dtype=keys.dtype)
    if values is None:
        return out
    return out, sv[0]


def test_plan_small_geometry():
    p = msd.plan_msd(100_000, 0, 32, **{k: v for k, v in SMALL.items()
                                         if k != "min_n"})
    assert p is not None
    assert len(p.passes) >= 2
    assert p.seg <= 2048 and p.seg % 128 == 0
    assert p.m_final == p.n_segments * p.seg
    for spec in p.passes:
        assert spec.k % (spec.r * 128) == 0


def test_plan_default_geometry():
    p = msd.plan_msd(1 << 26, 0, 32)
    assert p is not None
    assert p.m_final <= 2.1 * (1 << 26)
    assert p.seg <= 16384
    p28 = msd.plan_msd(1 << 28, 0, 32)
    assert p28 is not None and p28.seg <= 16384


@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32", "uint64",
                                    "float64"])
@pytest.mark.parametrize("n", [40_000, 65536])
def test_msd_keys_oracle(dtype, n):
    keys = datagen.random_keys(jax.random.key(n), n, dtype)
    got = _msd_sort(keys)
    want = np_sort_oracle(np.asarray(keys))
    assert np.array_equal(np.asarray(got).view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("entropy", [2, 3])
def test_msd_moderate_entropy(entropy):
    """Moderately skewed digits: either the padding absorbs it or the
    overflow fallback fires — output must be exact either way."""
    n = 50_000
    keys = datagen.entropy_keys(jax.random.key(1), n, entropy, "uint32")
    got = _msd_sort(keys)
    want = np_sort_oracle(np.asarray(keys))
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("entropy", [8, 0])
def test_msd_extreme_skew_fallback(entropy):
    """Entropy 8 / constant keys overflow every run -> lax.cond fallback."""
    n = 40_000
    keys = datagen.entropy_keys(jax.random.key(2), n, entropy, "uint32")
    got = _msd_sort(keys)
    want = np_sort_oracle(np.asarray(keys))
    np.testing.assert_array_equal(np.asarray(got), want)


def test_msd_pairs_stable():
    n = 40_000
    keys = datagen.entropy_keys(jax.random.key(3), n, 2, "uint32")
    vals = datagen.enumerated_values(n)
    gk, gv = _msd_sort(keys, vals)
    wk, wv = np_sort_oracle(np.asarray(keys), np.asarray(vals))
    np.testing.assert_array_equal(np.asarray(gk), wk)
    np.testing.assert_array_equal(np.asarray(gv), wv)


def test_msd_pairs_float_payload():
    n = 70_000
    keys = datagen.random_keys(jax.random.key(4), n, "uint32")
    vals = jax.random.uniform(jax.random.key(5), (n,), dtype=jnp.float32)
    gk, gv = _msd_sort(keys, vals)
    wk, wv = np_sort_oracle(np.asarray(keys), np.asarray(vals))
    np.testing.assert_array_equal(np.asarray(gk), wk)
    np.testing.assert_array_equal(np.asarray(gv), wv)


def test_msd_descending():
    n = 70_000
    keys = datagen.random_keys(jax.random.key(6), n, "float32")
    got = _msd_sort(keys, descending=True)
    want = np_sort_oracle(np.asarray(keys), descending=True)
    assert np.array_equal(np.asarray(got).view(np.uint8), want.view(np.uint8))


def test_msd_bit_range():
    n = 70_000
    keys = datagen.random_keys(jax.random.key(7), n, "uint32")
    vals = datagen.enumerated_values(n)
    gk, gv = _msd_sort(keys, vals, begin_bit=8, end_bit=24)
    wk, wv = np_sort_oracle(np.asarray(keys), np.asarray(vals),
                            begin_bit=8, end_bit=24)
    np.testing.assert_array_equal(np.asarray(gk), wk)
    np.testing.assert_array_equal(np.asarray(gv), wv)


def test_msd_uint64_pairs():
    n = 70_000
    keys = datagen.random_keys(jax.random.key(8), n, "uint64")
    vals = datagen.enumerated_values(n)
    gk, gv = _msd_sort(keys, vals)
    wk, wv = np_sort_oracle(np.asarray(keys), np.asarray(vals))
    np.testing.assert_array_equal(np.asarray(gk), wk)
    np.testing.assert_array_equal(np.asarray(gv), wv)


def test_msd_api_dispatch():
    """algorithm='msd' through the public API (default geometry; small n
    delegates to the reference path but must stay exact)."""
    n = 50_000
    keys = datagen.random_keys(jax.random.key(9), n, "uint32")
    got = tpusort.sort(keys, algorithm="msd")
    want = np_sort_oracle(np.asarray(keys))
    np.testing.assert_array_equal(np.asarray(got), want)


def test_msd_nonuniform_tail():
    """n far from tile multiples exercises initial-pad validity."""
    for n in (65537, 98304 + 17):
        keys = datagen.random_keys(jax.random.key(n), n, "uint32")
        got = _msd_sort(keys)
        want = np_sort_oracle(np.asarray(keys))
        np.testing.assert_array_equal(np.asarray(got), want)














def test_api_unstable_entry_points():
    n = 30_000
    keys = datagen.random_keys(jax.random.key(17), n, "uint32")
    vals = datagen.enumerated_values(n)
    gk, gv = tpusort.unstable_sort_pairs(keys, vals)
    got_pairs = sorted(zip(np.asarray(gk).tolist(), np.asarray(gv).tolist()))
    want_pairs = sorted(zip(np.asarray(keys).tolist(),
                            np.asarray(vals).tolist()))
    assert got_pairs == want_pairs
    gk2 = tpusort.unstable_sort_keys(keys)
    np.testing.assert_array_equal(np.asarray(gk2), np.sort(np.asarray(keys)))






def test_msd_overflow_flag_mode():
    """on_overflow='flag': no in-graph cond; the caller owns the fallback.
    Uniform keys -> flag False and output exact; constant keys -> flag
    True (output then invalid by contract)."""
    import jax
    from tpusort import dtypes as td
    from tpusort.ops import msd as _m
    from tpusort.utils import datagen
    from oracle import np_sort_oracle
    import numpy as np

    n = 9_000  # a few SMALL-geometry tiles; min_n=1 keeps the engine engaged
    keys = datagen.random_keys(jax.random.key(5), n, "uint32")
    planes, traits = td.twiddle_in(keys)
    sp, sv, ovf = _m.sort_twiddled_msd(
        planes, (), begin_bit=0, end_bit=32, total_bits=32,
        on_overflow="flag", plan_kwargs=dict(SMALL),
    )
    assert not bool(ovf)
    got = td.twiddle_out(sp, traits, dtype=keys.dtype)
    np.testing.assert_array_equal(np.asarray(got),
                                  np_sort_oracle(np.asarray(keys)))

    const = datagen.entropy_keys(jax.random.key(6), n, 0, "uint32")
    planes_c, _ = td.twiddle_in(const)
    _, _, ovf_c = _m.sort_twiddled_msd(
        planes_c, (), begin_bit=0, end_bit=32, total_bits=32,
        on_overflow="flag", plan_kwargs=dict(SMALL),
    )
    assert bool(ovf_c)


# ---------------------------------------------------------------------------
# Building blocks of the plain formulation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 1024), (3, 2048), (1, 128)])
def test_sort_tiles_rows_exact(shape):
    """Each row sorts independently; payload rides with its key."""
    rng = np.random.default_rng(shape[1])
    x = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    pay = x ^ np.uint32(0xABCD1234)
    got_k, got_p = msd._sort_tiles([jnp.asarray(x), jnp.asarray(pay)])
    np.testing.assert_array_equal(np.asarray(got_k), np.sort(x, axis=1))
    np.testing.assert_array_equal(np.asarray(got_p),
                                  np.asarray(got_k) ^ np.uint32(0xABCD1234))


@pytest.mark.parametrize("hi_range", [4, 1 << 16])
def test_two_key_lexicographic_leaf(hi_range):
    """Wide-remainder leaf: (hi, lo) planes sort lexicographically within
    each segment, heavy hi-plane ties included."""
    rng = np.random.default_rng(hi_range)
    nseg, seg = 4, 256
    hi = rng.integers(0, hi_range, nseg * seg).astype(np.uint32)
    lo = rng.integers(0, 2**32, nseg * seg, dtype=np.uint64).astype(np.uint32)
    plan = msd.MsdPlan(m1=nseg * seg, passes=(), seg=seg, n_segments=nseg,
                       m_final=nseg * seg, rem_lo=0, rem_width=64)
    valid = jnp.ones((nseg, seg), bool)
    (ghi, glo), counts = msd._leaf_sort(
        [jnp.asarray(hi), jnp.asarray(lo)], slice(0, 2), valid, plan)
    np.testing.assert_array_equal(np.asarray(counts), np.full(nseg, seg))
    comp = (hi.astype(np.uint64) << np.uint64(32)) | lo
    want = np.sort(comp.reshape(nseg, seg), axis=1).reshape(-1)
    got = (np.asarray(ghi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(glo).astype(np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_short", [0, 333])
def test_partition_pass_counts_and_runs(n_short):
    """One pass: counts equal the per-(tile, digit) histogram of the valid
    prefix, and each emitted run holds that digit's keys in input order
    (the pass is a stable binning)."""
    rng = np.random.default_rng(6 + n_short)
    T, K, R, S = 2, 1024, 8, 256
    x = rng.integers(0, 2**32, T * K, dtype=np.uint64).astype(np.uint32)
    n = T * K - n_short
    spec = msd.PassSpec(n_seg=1, t_seg=T, k=K, r=R, s=S, lo_bit=29, width=3)
    run_counts = jnp.clip(n - jnp.arange(T, dtype=jnp.int32) * K, 0, K)
    (out,), counts, overflow = msd._partition_pass(
        [jnp.asarray(x)], slice(0, 1), run_counts, K, spec)
    assert not bool(overflow)
    counts = np.asarray(counts).reshape(R, T)       # digit-major
    out = np.asarray(out).reshape(R, T, S)
    for t in range(T):
        tile = x[t * K: min((t + 1) * K, n)]
        for d in range(R):
            want = tile[(tile >> 29) == d]
            assert counts[d, t] == want.size
            np.testing.assert_array_equal(out[d, t, : want.size], want)


def test_uniform_keys_no_false_overflow():
    """Uniform keys must NOT trip the overflow flag — a silently-firing
    fallback masks engine bugs behind correct-but-slow output."""
    n = 6_000
    keys = datagen.random_keys(jax.random.key(14), n, "uint32")
    planes, _ = td.twiddle_in(keys)
    plan = msd.plan_msd(n, 0, 32, **{k: v for k, v in SMALL.items()
                                      if k != "min_n"})
    ops = [jnp.pad(planes[0], (0, plan.m1 - n))]
    _, _, overflow = msd._run_passes(ops, slice(0, 1), n, plan)
    assert not bool(overflow), "overflow fallback fired on uniform input"


_SEG = 256
_COUNT_CASES = {
    "ragged": [_SEG, 0, 117, 1, _SEG - 29],
    "all_empty_but_one": [0, 0, 0, 40, 0],
    "all_full": [_SEG] * 5,
    "leading_empty": [0, _SEG, 3, 0, 200],
}


@pytest.mark.parametrize("n_data", [1, 2])
@pytest.mark.parametrize("case", sorted(_COUNT_CASES))
@pytest.mark.parametrize("short", [0, 37])
def test_compact_segments(case, n_data, short):
    """Dense concatenation of the valid segment prefixes, for empty, full
    and ragged segments, and for an output shorter than the count sum."""
    counts = np.array(_COUNT_CASES[case], np.int32)
    nseg = counts.size
    rng = np.random.default_rng(nseg * 31 + short)
    ops = [rng.integers(0, 2**32, nseg * _SEG, dtype=np.uint64)
           .astype(np.uint32) for _ in range(n_data)]
    n_out = max(int(counts.sum()) - short, 1)
    got = msd.compact_segments([jnp.asarray(o) for o in ops],
                               jnp.asarray(counts), _SEG, n_out)
    for o, g in zip(ops, got):
        o2 = o.reshape(nseg, _SEG)
        want = np.concatenate([o2[s, :counts[s]] for s in range(nseg)])
        np.testing.assert_array_equal(np.asarray(g), want[:n_out])
