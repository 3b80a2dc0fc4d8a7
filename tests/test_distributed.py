"""Distributed global sort tests on the 8-virtual-device CPU mesh.

The capability the reference never had (single GPU) but the north star
requires: exact splitter selection, tie-quota skew handling, padded
all-to-all, overflow fallback — all validated against the numpy oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusort.parallel import global_sort as gs
from tpusort.utils import datagen
from oracle import np_sort_oracle


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 virtual devices, got {len(devs)}"
    return jax.make_mesh((8,), ("x",))


def test_global_sort_keys_uniform(mesh):
    n = 1 << 16
    keys = datagen.random_keys(jax.random.key(0), n, "uint32")
    got = gs.global_sort(keys, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got), np_sort_oracle(np.asarray(keys)))


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_global_sort_dtypes(mesh, dtype):
    n = 1 << 14
    keys = datagen.random_keys(jax.random.key(1), n, dtype)
    got = gs.global_sort(keys, mesh=mesh)
    want = np_sort_oracle(np.asarray(keys))
    assert np.array_equal(np.asarray(got).view(np.uint8), want.view(np.uint8))


def test_global_sort_descending(mesh):
    n = 1 << 14
    keys = datagen.random_keys(jax.random.key(2), n, "uint32")
    got = gs.global_sort(keys, mesh=mesh, descending=True)
    np.testing.assert_array_equal(
        np.asarray(got), np_sort_oracle(np.asarray(keys), descending=True)
    )


@pytest.mark.parametrize("entropy", [4, 0])
def test_global_sort_skew_tie_quota(mesh, entropy):
    """Heavy duplication: tie quotas must balance exactly (no overflow of
    any destination shard) and keys must stay exact."""
    n = 1 << 15
    keys = datagen.entropy_keys(jax.random.key(3), n, entropy, "uint32")
    got = gs.global_sort(keys, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got), np_sort_oracle(np.asarray(keys)))


def test_global_sort_presorted_overflow_fallback(mesh):
    """Globally pre-sorted input concentrates every (src,dst) pair ->
    capacity overflow -> allgather fallback, still exact."""
    n = 1 << 14
    keys = jnp.sort(datagen.random_keys(jax.random.key(4), n, "uint32"))
    got = gs.global_sort(keys, mesh=mesh, capacity_factor=1.0)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(keys))


def test_global_sort_pairs_permutation(mesh):
    """Pairs are unstable across hosts: verify with the reference's
    permutation semantics (every pair maps back, checksum exact)."""
    n = 1 << 14
    keys = datagen.entropy_keys(jax.random.key(5), n, 2, "uint32")
    vals = datagen.enumerated_values(n)
    gk, gv = gs.global_sort(keys, vals, mesh=mesh)
    gk, gv = np.asarray(gk), np.asarray(gv)
    np.testing.assert_array_equal(gk, np_sort_oracle(np.asarray(keys)))
    assert int(gv.astype(np.uint64).sum()) == n * (n - 1) // 2
    np.testing.assert_array_equal(np.asarray(keys)[gv], gk)


def test_global_sort_zipf(mesh):
    """Zipfian keys (the skewed-build distribution, 32-bit variant)."""
    n = 1 << 14
    keys = datagen.zipf_keys(jax.random.key(6), n, alpha=1.2, dtype=jnp.uint32)
    got = gs.global_sort(keys, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got), np_sort_oracle(np.asarray(keys)))


# ---------------------------------------------------------------------------
# Round 2: 64-bit planes, chunked exchange, engine finish
# ---------------------------------------------------------------------------


def test_global_sort_u64_planes(mesh):
    """2-plane (u64) keys with a heavily skewed hi plane: lexicographic
    splitter selection + multi-plane tie quotas."""
    n = 1 << 14
    rng = np.random.default_rng(7)
    hi = jnp.asarray(rng.integers(0, 3, n).astype(np.uint32))
    lo = jnp.asarray(rng.integers(0, 1 << 32, n, dtype=np.int64)
                     .astype(np.uint32))
    sorter = gs.make_global_sort_planes(mesh, key_dtype="uint64")
    ohi, olo = sorter((hi, lo))
    got = (np.asarray(ohi).astype(np.uint64) << 32) | np.asarray(olo)
    want = np.sort((np.asarray(hi).astype(np.uint64) << 32)
                   | np.asarray(lo).astype(np.uint64))
    np.testing.assert_array_equal(got, want)


def test_global_sort_u64_dtype(mesh):
    """64-bit dtype through the array API (CPU backend materializes u64)."""
    n = 1 << 14
    keys = datagen.random_keys(jax.random.key(8), n, "uint64")
    got = gs.global_sort(keys, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.sort(np.asarray(keys)))


def test_global_sort_i64_planes_descending(mesh):
    n = 1 << 13
    rng = np.random.default_rng(9)
    v = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    u = v.view(np.uint64)
    hi = jnp.asarray((u >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    sorter = gs.make_global_sort_planes(mesh, key_dtype="int64")
    ohi, olo = sorter((hi, lo), descending=True)
    got = (((np.asarray(ohi).astype(np.uint64) << 32)
            | np.asarray(olo))).view(np.int64)
    np.testing.assert_array_equal(got, np.sort(v)[::-1])


def test_global_sort_chunked_exchange(mesh):
    """chunks > 1 splits the all-to-all along the capacity axis; results
    are identical to the monolithic exchange."""
    n = 1 << 14
    keys = datagen.entropy_keys(jax.random.key(10), n, 2, "uint32")
    got1 = np.asarray(gs.global_sort(keys, mesh=mesh, chunks=1))
    got4 = np.asarray(gs.global_sort(keys, mesh=mesh, chunks=4))
    np.testing.assert_array_equal(got1, got4)
    np.testing.assert_array_equal(got4, np_sort_oracle(np.asarray(keys)))


def test_global_sort_chunked_pairs(mesh):
    n = 1 << 14
    keys = datagen.zipf_keys(jax.random.key(11), n, alpha=1.2,
                             dtype=jnp.uint32)
    vals = datagen.enumerated_values(n)
    gk, gv = gs.global_sort(keys, vals, mesh=mesh, chunks=2)
    gk, gv = np.asarray(gk), np.asarray(gv)
    np.testing.assert_array_equal(gk, np_sort_oracle(np.asarray(keys)))
    assert int(gv.astype(np.uint64).sum()) == n * (n - 1) // 2
    np.testing.assert_array_equal(np.asarray(keys)[gv], gk)


def test_global_sort_u64_pairs(mesh):
    """2-plane keys + payload: finishes via the variadic sort path."""
    n = 1 << 13
    rng = np.random.default_rng(12)
    hi = jnp.asarray(rng.integers(0, 5, n).astype(np.uint32))
    lo = jnp.asarray(rng.integers(0, 1 << 16, n).astype(np.uint32))
    vals = datagen.enumerated_values(n)
    sorter = gs.make_global_sort_planes(mesh, key_dtype="uint64")
    (ohi, olo), ov = sorter((hi, lo), vals)
    got = (np.asarray(ohi).astype(np.uint64) << 32) | np.asarray(olo)
    orig = (np.asarray(hi).astype(np.uint64) << 32) | np.asarray(lo)
    np.testing.assert_array_equal(got, np.sort(orig))
    gv = np.asarray(ov)
    assert int(gv.astype(np.uint64).sum()) == n * (n - 1) // 2
    np.testing.assert_array_equal(orig[gv], got)


def test_geometry_2e32_traces(mesh):
    """Global-sort geometry at scale: a 2^32-key global sort (2^29 per
    device x 8) must TRACE with 32-bit index math — global counts
    (splitter `below`, tie prefixes) are uint32, mirroring the reference's
    own unsigned-int ceiling (gpu_radix_sort.h:190).  Trace-only: no
    buffers are materialized, so this runs on the CPU mesh."""
    d = 8
    n = 1 << 32
    n_shard = n // d
    capacity = gs._capacity_for(n_shard, d, 4.0, 2)
    shard_fn = gs._make_sharded_body(
        mesh, "x", nplanes=1, n_values=1, n_shard=n_shard, d=d,
        capacity=capacity, chunks=2,
    )
    out = jax.eval_shape(
        shard_fn,
        jax.ShapeDtypeStruct((n,), jnp.uint32),
        jax.ShapeDtypeStruct((n,), jnp.uint32),
    )
    assert tuple(o.shape for o in out) == ((n,), (n,))


def test_geometry_2e32_u64_traces(mesh):
    """Same at 2-plane (64-bit) keys with payload: 3 operands, chunks=4."""
    d = 8
    n = 1 << 32
    n_shard = n // d
    capacity = gs._capacity_for(n_shard, d, 4.0, 4)
    shard_fn = gs._make_sharded_body(
        mesh, "x", nplanes=2, n_values=1, n_shard=n_shard, d=d,
        capacity=capacity, chunks=4,
    )
    out = jax.eval_shape(
        shard_fn,
        *[jax.ShapeDtypeStruct((n,), jnp.uint32) for _ in range(3)],
    )
    assert tuple(o.shape for o in out) == ((n,),) * 3


@pytest.mark.slow
@pytest.mark.parametrize("chunks", [1, 4])
def test_global_sort_scale_zipf_pairs(mesh, chunks):
    """Capacity heuristic at scale: 2^20 heavy-skew zipf pairs across 8
    devices, chunked and monolithic exchanges — exact against the oracle
    (small-geometry tests cannot stress per-(src,dst) capacity variance)."""
    n = 1 << 20
    keys = datagen.zipf_keys(jax.random.key(7), n, alpha=1.1,
                             dtype=jnp.uint32)
    vals = datagen.enumerated_values(n)
    sorter = gs.make_global_sort(mesh, chunks=chunks)
    gk, gv = sorter(keys, vals)
    gk, gv = np.asarray(gk), np.asarray(gv)
    k = np.asarray(keys)
    np.testing.assert_array_equal(gk, np.sort(k))
    # unstable-pair semantics: every output pair maps back to its key and
    # the value checksum is the full permutation
    np.testing.assert_array_equal(k[gv], gk)
    assert int(gv.astype(np.uint64).sum()) == n * (n - 1) // 2


def test_global_sort_adaptive_capacity(mesh):
    """Host-owned adaptive capacity tier: a pre-sorted input makes every
    (src==dst) bucket count n_shard — guaranteed overflow at a small
    capacity_factor.  Every call must stay exact (in-graph allgather
    fallback), and repeated calls must double the geometry's factor until
    capacity saturates at n_shard, where overflow is impossible."""
    n = 1 << 13
    d = 8
    n_shard = n // d
    keys = jnp.arange(n, dtype=jnp.uint32)
    want = np.arange(n, dtype=np.uint32)
    sorter = gs.make_global_sort(mesh, capacity_factor=1.0, adaptive=True)
    caps = []
    for _ in range(5):
        np.testing.assert_array_equal(np.asarray(sorter(keys)), want)
        caps.append(max(g[-1] for g in sorter._shard_fns))
    # strictly growing capacities until saturation, then stable
    assert caps[-1] == n_shard, caps
    assert all(b >= a for a, b in zip(caps, caps[1:])), caps
    assert caps[0] < caps[-1], caps
    # saturated: no further growth, no recompile churn
    n_fns = len(sorter._shard_fns)
    np.testing.assert_array_equal(np.asarray(sorter(keys)), want)
    assert len(sorter._shard_fns) == n_fns
    # planes variant: same tier (one overflowing call bumps the factor)
    ps = gs.make_global_sort_planes(mesh, key_dtype="uint64",
                                    capacity_factor=1.0, adaptive=True)
    hi = jnp.zeros((n,), jnp.uint32)
    (ohi, olo) = ps((hi, keys))
    np.testing.assert_array_equal(np.asarray(olo), want)
    assert np.asarray(ohi).sum() == 0
    assert ps._factors, "overflowing planes call must adapt the factor"


def test_global_sort_planes_single_device():
    """d == 1 degenerates to the local engine (regression: the planes
    variant lacked the guard and indexed an empty below[] tie array)."""
    mesh = jax.make_mesh((1,), ("x",))
    sorter = gs.make_global_sort_planes(mesh, key_dtype="uint64")
    rng = np.random.default_rng(7)
    n = 4096
    hi = jnp.asarray(rng.integers(0, 1 << 32, n, dtype=np.int64)
                     .astype(np.uint32))
    lo = jnp.asarray(rng.integers(0, 1 << 32, n, dtype=np.int64)
                     .astype(np.uint32))
    ohi, olo = sorter((hi, lo))
    g = (np.asarray(ohi).astype(np.uint64) << 32) | np.asarray(olo)
    w = np.sort((np.asarray(hi).astype(np.uint64) << 32)
                | np.asarray(lo))
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("pairs", [False, True])
def test_global_sort_chunks_keys_pairs(mesh, chunks, pairs):
    """Every chunk count of the padded all-to-all, keys-only and with an
    enumerated payload: keys exact, every pair bound to its key, payload a
    full permutation."""
    n = 1 << 14
    keys = datagen.entropy_keys(jax.random.key(40 + chunks), n, 2, "uint32")
    sorter = gs.make_global_sort(mesh, chunks=chunks)
    want = np_sort_oracle(np.asarray(keys))
    if not pairs:
        np.testing.assert_array_equal(np.asarray(sorter(keys)), want)
        return
    vals = datagen.enumerated_values(n)
    gk, gv = sorter(keys, vals)
    gk, gv = np.asarray(gk), np.asarray(gv)
    np.testing.assert_array_equal(gk, want)
    np.testing.assert_array_equal(np.asarray(keys)[gv], gk)
    np.testing.assert_array_equal(np.sort(gv), np.arange(n, dtype=np.uint32))
