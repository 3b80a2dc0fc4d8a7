"""End-to-end sort API tests against the independent numpy oracle.

Port of the reference's test strategy (``msb/tests/test_sort_keys.cu``,
``test_sort_pairs.cu``, SURVEY.md §4):

* oracle comparison with bitwise equality (handles NaN),
* entropy sweep {0, 1, 2, 4, 8} (AND of k uniform draws; 0 = constant),
* size sweep including non-power-of-two and tiny sizes,
* pair permutation-checksum verification with enumerated values,
* descending and bit-range variants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpusort
from tpusort.utils import datagen
from oracle import np_sort_oracle

KEY_DTYPES = ["uint32", "int32", "float32", "uint64", "int64", "float64"]
ENTROPIES = [1, 2, 4, 0]
SIZES = [1, 2, 100, 1000, 4097, 30000]


def _gen(dtype, n, entropy, seed=0):
    k = jax.random.key(seed)
    if entropy == 1:
        return datagen.random_keys(k, n, dtype)
    return datagen.entropy_keys(k, n, entropy, dtype)


def _assert_bitwise_equal(got, want, msg=""):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if not np.array_equal(got.view(np.uint8), want.view(np.uint8)):
        bad = np.nonzero(got.view(np.uint8) != want.view(np.uint8))[0]
        raise AssertionError(f"{msg} first byte mismatch at {bad[:10]}")


# Engines with exact sorted-keys output (bitonic/msd_unstable may reorder
# equal-key payloads).
KEYS_ALGORITHMS = ["reference", "msd", "msd_unstable", "bitonic"]
# Engines with stable (position-preserving) pair semantics.
STABLE_ALGORITHMS = ["reference", "msd"]


def engines(names=KEYS_ALGORITHMS):
    return [a for a in names if a in tpusort.available_engines()]


@pytest.mark.parametrize("algorithm", engines())
@pytest.mark.parametrize("dtype", KEY_DTYPES)
@pytest.mark.parametrize("entropy", ENTROPIES)
def test_sort_keys_oracle(algorithm, dtype, entropy):
    n = 10000
    keys = _gen(dtype, n, entropy)
    got = tpusort.sort(keys, algorithm=algorithm)
    want = np_sort_oracle(np.asarray(keys))
    _assert_bitwise_equal(got, want, f"{algorithm}/{dtype}/entropy={entropy}")


@pytest.mark.parametrize("algorithm", engines())
@pytest.mark.parametrize("n", SIZES)
def test_sort_size_sweep(algorithm, n):
    keys = _gen("uint32", n, 1, seed=n)
    got = tpusort.sort(keys, algorithm=algorithm)
    want = np_sort_oracle(np.asarray(keys))
    _assert_bitwise_equal(got, want, f"{algorithm}/n={n}")


@pytest.mark.parametrize("algorithm", engines())
@pytest.mark.parametrize("dtype", ["uint32", "float32", "uint64"])
def test_sort_descending(algorithm, dtype):
    n = 8192
    keys = _gen(dtype, n, 2)
    got = tpusort.sort(keys, descending=True, algorithm=algorithm)
    want = np_sort_oracle(np.asarray(keys), descending=True)
    _assert_bitwise_equal(got, want, f"{algorithm}/{dtype}/desc")


@pytest.mark.parametrize("algorithm", engines(STABLE_ALGORITHMS))
@pytest.mark.parametrize("dtype,begin,end", [
    ("uint32", 0, 16),
    ("uint32", 8, 24),
    ("uint64", 16, 48),
    ("float32", 4, 30),
])
def test_bit_range_subsort(algorithm, dtype, begin, end):
    """Stable sub-range sort: only bits [begin,end) compared; ties keep
    input order (cub begin_bit/end_bit semantics)."""
    n = 5000
    keys = _gen(dtype, n, 1)
    vals = datagen.enumerated_values(n)
    gk, gv = tpusort.sort(keys, vals, begin_bit=begin, end_bit=end,
                          algorithm=algorithm)
    wk, wv = np_sort_oracle(np.asarray(keys), np.asarray(vals),
                            begin_bit=begin, end_bit=end)
    _assert_bitwise_equal(gk, wk)
    np.testing.assert_array_equal(np.asarray(gv), wv)


@pytest.mark.parametrize("algorithm", engines(STABLE_ALGORITHMS))
@pytest.mark.parametrize("dtype", ["uint32", "uint64", "float32"])
@pytest.mark.parametrize("entropy", [1, 3, 0])
def test_sort_pairs_stable(algorithm, dtype, entropy):
    """Stable engines must match the stable oracle on values exactly."""
    n = 20000
    keys = _gen(dtype, n, entropy)
    vals = datagen.enumerated_values(n)
    gk, gv = tpusort.sort(keys, vals, algorithm=algorithm)
    wk, wv = np_sort_oracle(np.asarray(keys), np.asarray(vals))
    _assert_bitwise_equal(gk, wk)
    np.testing.assert_array_equal(np.asarray(gv), wv)


@pytest.mark.parametrize("algorithm", engines())
def test_sort_pairs_permutation_checksum(algorithm):
    """The reference's fast pair check (test_sort_pairs.cu:141-175):
    values are the 0..N-1 permutation; every output pair must map back to
    its original key and the value checksum must be N(N-1)/2."""
    n = 30000
    keys = _gen("uint32", n, 2)
    vals = datagen.enumerated_values(n)
    gk, gv = tpusort.sort(keys, vals, algorithm=algorithm)
    gk, gv = np.asarray(gk), np.asarray(gv)
    orig = np.asarray(keys)
    assert int(gv.astype(np.uint64).sum()) == n * (n - 1) // 2
    np.testing.assert_array_equal(orig[gv], gk)


@pytest.mark.parametrize("algorithm", engines(STABLE_ALGORITHMS))
def test_multi_payload(algorithm):
    n = 4096
    keys = _gen("uint32", n, 1)
    v1 = datagen.enumerated_values(n)
    v2 = jnp.asarray(np.random.default_rng(1).random(n, dtype=np.float32))
    gk, (g1, g2) = tpusort.sort(keys, (v1, v2), algorithm=algorithm)
    wk, w1 = np_sort_oracle(np.asarray(keys), np.asarray(v1))
    _assert_bitwise_equal(gk, wk)
    np.testing.assert_array_equal(np.asarray(g1), w1)
    np.testing.assert_array_equal(np.asarray(g2), np.asarray(v2)[w1])


@pytest.mark.parametrize("algorithm", engines(["reference", "msd"]))
@pytest.mark.parametrize("entropy", list(range(1, 12)) + [0])
def test_entropy_ladder_full(algorithm, entropy):
    """The reference's full entropy ladder {1..11, 0} (AND of k uniform
    draws; 0 = constant zeros — ``test_sort_keys.cu:126``,
    ``data_gen.h:55-70``), through the public API."""
    n = 20000
    keys = _gen("uint32", n, entropy, seed=entropy)
    got = tpusort.sort(keys, algorithm=algorithm)
    want = np_sort_oracle(np.asarray(keys))
    _assert_bitwise_equal(got, want, f"{algorithm}/entropy={entropy}")


def test_argsort():
    n = 3000
    keys = _gen("float32", n, 1)
    perm = tpusort.argsort(keys)
    want = np.argsort(np.asarray(np_sort_oracle(np.asarray(keys))), kind="stable")
    # verify via application, not permutation equality (ties)
    _assert_bitwise_equal(np.asarray(keys)[np.asarray(perm)],
                          np_sort_oracle(np.asarray(keys)))


def test_cub_flavored_wrappers():
    n = 1024
    keys = _gen("uint32", n, 1)
    vals = datagen.enumerated_values(n)
    np.testing.assert_array_equal(
        np.asarray(tpusort.sort_keys(keys)), np.asarray(tpusort.sort(keys))
    )
    gk, gv = tpusort.sort_pairs_descending(keys, vals)
    wk, wv = np_sort_oracle(np.asarray(keys), np.asarray(vals), descending=True)
    _assert_bitwise_equal(gk, wk)
    np.testing.assert_array_equal(np.asarray(gv), wv)


def test_sort_planes_u64():
    """Plane-level 64-bit interface (no 64-bit arrays materialized)."""
    import numpy as np
    from tpusort.utils import datagen
    n = 40_000
    hi = datagen.random_keys(jax.random.key(50), n, "uint32")
    lo = datagen.random_keys(jax.random.key(51), n, "uint32")
    ohi, olo = tpusort.sort_planes((hi, lo), key_dtype="uint64")
    got = (np.asarray(ohi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(olo).astype(np.uint64)
    want = np.sort((np.asarray(hi).astype(np.uint64) << np.uint64(32))
                   | np.asarray(lo).astype(np.uint64))
    np.testing.assert_array_equal(got, want)


def test_sort_planes_f64_descending_pairs():
    import numpy as np
    from tpusort.utils import datagen
    n = 30_000
    f = np.random.default_rng(0).standard_normal(n)
    u = f.view(np.uint64)
    hi = jnp.asarray((u >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    vals = datagen.enumerated_values(n)
    (ohi, olo), ov = tpusort.sort_planes(
        (hi, lo), vals, key_dtype="float64", descending=True)
    got = (((np.asarray(ohi).astype(np.uint64) << np.uint64(32))
            | np.asarray(olo).astype(np.uint64))).view(np.float64)
    order = np.argsort(-f, kind="stable")
    np.testing.assert_array_equal(got, f[order])
    np.testing.assert_array_equal(np.asarray(ov), np.asarray(vals)[order])


def test_size_sweep_geometric():
    """Size sweep in ~x10^0.25 geometric steps (the reference sweeps
    x10^0.1 from 100k, test_sort_keys.cu:175-195; coarser here to keep CPU
    CI fast) — every size oracle-exact through the public API."""
    import numpy as np
    from tpusort.utils import datagen
    n = 30_000
    while n <= 1_000_000:
        keys = datagen.random_keys(jax.random.key(n), n, "uint32")
        got = np.asarray(tpusort.sort(keys))
        np.testing.assert_array_equal(got, np.sort(np.asarray(keys)))
        n = int(n * (10 ** 0.25))


def test_sort_pairs_lsb_in_value():
    """NUM_LSB_IN_VALUE analog: sort by (key || low value bytes), full
    value carried (gpu_radix_sort.h:195-206)."""
    n = 20_000
    rng = np.random.default_rng(77)
    # few distinct keys so the value bytes decide most of the order
    keys = jnp.asarray(rng.integers(0, 8, n).astype(np.uint32))
    vals = jnp.asarray(rng.integers(0, 1 << 32, n, dtype=np.int64)
                       .astype(np.uint32))
    for b in (1, 2, 4):
        gk, gv = tpusort.sort_pairs_lsb_in_value(keys, vals, b)
        gk, gv = np.asarray(gk), np.asarray(gv)
        mask = np.uint64((1 << (8 * b)) - 1)
        comp = (np.asarray(keys).astype(np.uint64) << np.uint64(32)) | (
            np.asarray(vals).astype(np.uint64) & mask)
        order = np.argsort(comp, kind="stable")
        got_comp = (gk.astype(np.uint64) << np.uint64(32)) | (
            gv.astype(np.uint64) & mask)
        np.testing.assert_array_equal(got_comp, np.sort(comp))
        # permutation check: multiset of (key, full value) pairs preserved
        got_pairs = (gk.astype(np.uint64) << np.uint64(32)) | gv.astype(
            np.uint64)
        want_pairs = (np.asarray(keys).astype(np.uint64) << np.uint64(32)
                      ) | np.asarray(vals).astype(np.uint64)
        np.testing.assert_array_equal(np.sort(got_pairs),
                                      np.sort(want_pairs))
    # descending
    gk, gv = tpusort.sort_pairs_lsb_in_value(keys, vals, 4, descending=True)
    comp = (np.asarray(keys).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(vals).astype(np.uint64)
    got = (np.asarray(gk).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(gv).astype(np.uint64)
    np.testing.assert_array_equal(got, np.sort(comp)[::-1])


@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32"])
@pytest.mark.parametrize("descending", [False, True])
def test_argsort_stable_ties(dtype, descending):
    """argsort's composite fast path (2-operand (key || index) planes)
    must stay STABLE: tied keys keep ascending original indices, both
    directions, across the twiddled dtypes."""
    from oracle import np_twiddle

    n = 4096
    keys = _gen(dtype, n, 2, seed=5)      # low entropy: heavy ties
    perm = np.asarray(tpusort.argsort(keys, descending=descending))
    k = np.asarray(keys)
    tw = np_twiddle(k).astype(np.uint64)
    if descending:
        tw = np.uint64(0xFFFFFFFF) - tw
    want = np.argsort(tw, kind="stable")
    np.testing.assert_array_equal(perm, want)
    if dtype == "uint32":
        # drive the composite path through the msd ENGINE too (the CPU
        # config's min_n=4096 lets the pass pipeline run at this size)
        perm2 = np.asarray(
            tpusort.argsort(keys, descending=descending, algorithm="msd"))
        np.testing.assert_array_equal(perm2, want)


def test_sort_rejects_2d_and_bad_bit_range():
    """Validation must hold on EVERY dispatch path, including the
    host-tiered one (a 2-D input was silently column-'sorted')."""
    with pytest.raises(NotImplementedError):
        tpusort.sort(jnp.zeros((4, 8), jnp.uint32), algorithm="msd")
    with pytest.raises(ValueError):
        tpusort.sort(jnp.zeros((128,), jnp.uint32), begin_bit=40,
                     algorithm="msd")
    with pytest.raises(ValueError):
        tpusort.sort_planes(
            (jnp.zeros((128,), jnp.uint32),) * 2, begin_bit=70,
            algorithm="msd")


def test_legacy_engine_signature_still_works():
    """Engines registered against the documented contract (no config
    kwarg) must keep working after the config plumbing."""
    from tpusort.ops.reference import sort_twiddled_reference

    def legacy(planes, values, *, begin_bit, end_bit, total_bits):
        return sort_twiddled_reference(
            planes, values, begin_bit=begin_bit, end_bit=end_bit,
            total_bits=total_bits)

    tpusort.register_engine("_legacy_test", legacy)
    try:
        keys = _gen("uint32", 2048, 3, seed=9)
        got = tpusort.sort(keys, algorithm="_legacy_test")
        _assert_bitwise_equal(got, np_sort_oracle(np.asarray(keys)))
    finally:
        from tpusort import api as _api
        _api._ENGINES.pop("_legacy_test", None)


class Test64BitHostBoundary:
    """Public ``sort()`` accepts 64-bit dtypes via the host plane boundary
    (with ``jax_enable_x64`` off JAX holds no 64-bit arrays): keys/values
    are bitcast to uint32 planes host-side, sorted through the plane
    interface, and reassembled as numpy.  Covers the reference's full ``Traits`` dtype set
    (``lsb/cub/cub/util_type.cuh:1104-1130``) and its {4,8}-byte
    key x value tuning matrix (``msb/src/sort/gpu_sort_config.h:146-207``)
    at the top-level API."""

    @pytest.fixture(autouse=True)
    def _x64_off(self):
        # JAX's default is x64 DISABLED — the configuration the host
        # boundary exists for; the rest of the suite keeps conftest's x64
        # to exercise the device-side plane decomposition
        old = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", False)
        yield
        jax.config.update("jax_enable_x64", old)

    @staticmethod
    def _rand64(n, dtype, seed=0):
        rng = np.random.default_rng(seed)
        u = np.frombuffer(rng.bytes(n * 8), np.uint64).copy()
        if dtype == "float64":
            f = u.view(np.float64)
            # pin the interesting rungs of the float total order
            f[:8] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5, -1.5]
            return f
        return u.view(np.dtype(dtype))

    @pytest.mark.parametrize("dtype", ["uint64", "int64", "float64"])
    def test_keys_oracle(self, dtype):
        k = self._rand64(6000, dtype, seed=11)
        got = tpusort.sort(k, algorithm="msd")
        assert isinstance(got, np.ndarray) and got.dtype == np.dtype(dtype)
        want = np_sort_oracle(k)
        np.testing.assert_array_equal(got.view(np.uint64),
                                      want.view(np.uint64))

    def test_keys_descending_f64(self):
        k = self._rand64(5000, "float64", seed=12)
        got = tpusort.sort(k, algorithm="msd", descending=True)
        want = np_sort_oracle(k, descending=True)
        np.testing.assert_array_equal(got.view(np.uint64),
                                      want.view(np.uint64))

    def test_u64_keys_u32_values_stable(self):
        n = 5000
        k = (self._rand64(n, "uint64", seed=13) & np.uint64(0xFF)) | \
            np.uint64(0xA500000000000000)   # heavy ties exercise stability
        v = np.arange(n, dtype=np.uint32)
        gk, gv = tpusort.sort(k, v, algorithm="msd")
        wk, wv = np_sort_oracle(k, v)
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(np.asarray(gv), wv)

    def test_u32_keys_u64_values(self):
        n = 5000
        rng = np.random.default_rng(14)
        k = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        v = self._rand64(n, "uint64", seed=15)
        gk, gv = tpusort.sort(k, v, algorithm="msd")
        wk, wv = np_sort_oracle(k, v)
        np.testing.assert_array_equal(np.asarray(gk), wk)
        assert isinstance(gv, np.ndarray) and gv.dtype == np.uint64
        np.testing.assert_array_equal(gv, wv)

    def test_u64_keys_u64_values_multi(self):
        n = 4000
        k = self._rand64(n, "uint64", seed=16)
        v64 = self._rand64(n, "uint64", seed=17)
        v32 = np.arange(n, dtype=np.uint32)
        gk, (gv64, gv32) = tpusort.sort(k, (v64, v32), algorithm="msd")
        wk, wv64 = np_sort_oracle(k, v64)
        _, wv32 = np_sort_oracle(k, v32)
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gv64, wv64)
        np.testing.assert_array_equal(np.asarray(gv32), wv32)

    def test_argsort_u64(self):
        k = self._rand64(4000, "uint64", seed=18)
        perm = tpusort.argsort(k)
        np.testing.assert_array_equal(
            k[np.asarray(perm)], np_sort_oracle(k))

    def test_inside_jit_raises(self):
        k = self._rand64(256, "uint64")

        @jax.jit
        def f(x):
            return tpusort.sort(k, algorithm="msd")  # captures 64-bit host

        # tracer VALUES alongside 64-bit keys must be rejected, not silently
        # fetched; plain host arrays keep working inside jit-free code
        @jax.jit
        def g(v):
            return tpusort.sort(k, v, algorithm="msd")

        with pytest.raises(NotImplementedError):
            g(jnp.arange(256, dtype=jnp.uint32))
