"""Host-owned tiering: radix flag-mode -> exact.

The analog of the reference's CPU-in-the-loop pass planner
(``msb/src/sort/gpu_radix_sort.cu:29-104``): the host reads a tiny overflow
flag and re-dispatches, so no in-graph fallback workspace is reserved where
it would not fit the device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpusort
from tpusort.configs import SortConfig, get_config, register_config
from tpusort.utils import datagen
from oracle import np_sort_oracle


def _with_cfg(cfg, fn):
    platform = jax.default_backend()
    saved = get_config(32, False), get_config(32, True)
    register_config(32, False, platform, cfg)
    register_config(32, True, platform, cfg)
    try:
        return fn()
    finally:
        register_config(32, False, platform, saved[0])
        register_config(32, True, platform, saved[1])


CPU_CFG = SortConfig(tile_elems=2048, radix=16, s1=256, min_n=4096)


def test_tier_overflow_routes_to_exact():
    """Constant keys overflow the radix capacities deterministically; the
    host chain must land on the exact tier and return oracle output."""
    n = 20_000
    keys = jnp.zeros((n,), jnp.uint32) + jnp.uint32(7)

    def run():
        return np.asarray(tpusort.sort(keys, algorithm="msd"))

    got = _with_cfg(CPU_CFG, run)
    np.testing.assert_array_equal(got, np.full(n, 7, np.uint32))


def test_tier_no_overflow_single_dispatch():
    n = 20_000
    keys = datagen.random_keys(jax.random.key(3), n, "uint32")

    def run():
        return np.asarray(tpusort.sort(keys, algorithm="msd"))

    got = _with_cfg(CPU_CFG, run)
    np.testing.assert_array_equal(got, np_sort_oracle(np.asarray(keys)))


def test_tier_pairs_stable_overflow():
    """Stable pairs through the tier chain on skewed input stay stable."""
    n = 20_000
    keys = datagen.entropy_keys(jax.random.key(4), n, 0, "uint32")
    vals = datagen.enumerated_values(n)

    def run():
        gk, gv = tpusort.sort(keys, vals, algorithm="msd")
        return np.asarray(gk), np.asarray(gv)

    gk, gv = _with_cfg(CPU_CFG, run)
    wk, wv = np_sort_oracle(np.asarray(keys), np.asarray(vals))
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)


def test_sort_inside_jit_uses_in_graph_fallback():
    """Inside a user jit the keys are tracers: the in-graph lax.cond path
    must apply (host tiering needs concrete inputs) and stay exact."""
    n = 20_000
    keys = datagen.entropy_keys(jax.random.key(5), n, 0, "uint32")

    @jax.jit
    def f(k):
        return tpusort.sort(k, algorithm="msd")

    got = _with_cfg(CPU_CFG, lambda: np.asarray(f(keys)))
    np.testing.assert_array_equal(got, np_sort_oracle(np.asarray(keys)))





def test_doomed_sample_skips_to_exact(monkeypatch):
    """A sample that predicts radix overflow (Zipf duplication) sends the
    call straight to the exact tier: one dispatch, no doomed radix run."""
    from tpusort import api, planner

    monkeypatch.setattr(planner, "PLANNER_MIN_N", 1 << 10)
    api._TIER_CACHE.clear()
    tiers = []
    orig = api._sort_tier_impl

    def spy(*a, **k):
        tiers.append(k["tier"])
        return orig(*a, **k)

    monkeypatch.setattr(api, "_sort_tier_impl", spy)
    n = 20_000
    keys = datagen.zipf_keys(jax.random.key(6), n, alpha=1.2,
                             dtype=jnp.uint32)
    got = _with_cfg(CPU_CFG,
                    lambda: np.asarray(tpusort.sort(keys, algorithm="msd")))
    np.testing.assert_array_equal(got, np_sort_oracle(np.asarray(keys)))
    assert tiers == ["exact"], tiers

class TestPresortedShortCircuit:
    """Already-sorted identity short-circuit (the reference's finished
    buckets skipping remaining passes, gpu_radix_sort.h:359-360,482-485):
    a sorted or constant input must return unchanged without entering the
    tier chain; a misleading sample (sorted sample, unsorted input) must
    fall through to a correct sort."""

    def _patch(self, monkeypatch, small_min_n=True):
        from tpusort import api, planner

        if small_min_n:
            monkeypatch.setattr(planner, "PLANNER_MIN_N", 1 << 10)
        calls = []
        orig = api._run_tier_chain

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        monkeypatch.setattr(api, "_run_tier_chain", spy)
        return calls

    @pytest.mark.parametrize("make", [
        lambda n: np.sort(np.random.default_rng(0).integers(
            0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)),
        lambda n: np.full(n, 7, np.uint32),          # entropy-0 rung
        lambda n: np.zeros(n, np.float32),
    ])
    def test_identity(self, monkeypatch, make):
        calls = self._patch(monkeypatch)
        k = jnp.asarray(make(1 << 12))
        out = tpusort.sort(k, algorithm="msd")
        np.testing.assert_array_equal(np.asarray(out), np.asarray(k))
        assert not calls, "short-circuit must bypass the tier chain"

    def test_identity_pairs(self, monkeypatch):
        calls = self._patch(monkeypatch)
        n = 1 << 12
        k = jnp.asarray(np.sort(np.random.default_rng(1).integers(
            0, 1000, n, dtype=np.int64).astype(np.int32)))
        v = jnp.arange(n, dtype=jnp.uint32)
        ok, ov = tpusort.sort(k, v, algorithm="msd")
        np.testing.assert_array_equal(np.asarray(ok), np.asarray(k))
        np.testing.assert_array_equal(np.asarray(ov), np.asarray(v))
        assert not calls

    def test_descending_presorted(self, monkeypatch):
        calls = self._patch(monkeypatch)
        n = 1 << 12
        k = jnp.asarray(np.sort(np.random.default_rng(2).integers(
            0, 1 << 32, n, dtype=np.uint64).astype(np.uint32))[::-1].copy())
        out = tpusort.sort(k, algorithm="msd", descending=True)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(k))
        assert not calls

    def test_misleading_sample_falls_through(self, monkeypatch):
        # sample (stride picks index 0 mod stride) sorted, full input not:
        # device check must reject and the tier chain must run
        from tpusort import planner

        calls = self._patch(monkeypatch)
        n = 1 << 12
        stride = max(1, n // planner.SAMPLE_TARGET)
        base = np.sort(np.random.default_rng(3).integers(
            0, 1 << 31, n, dtype=np.uint64).astype(np.uint32))
        base[1] = base[-1] + 1  # not sampled when stride > 1; breaks order
        k = jnp.asarray(base)
        out = tpusort.sort(k, algorithm="msd")
        np.testing.assert_array_equal(np.asarray(out), np.sort(base))
        if stride == 1:
            assert calls  # sample saw the break; normal path
        # (with stride > 1 either path is correct; output equality is the
        # contract)

    def test_sorted_planes_short_circuit(self, monkeypatch):
        calls = self._patch(monkeypatch)
        n = 1 << 12
        rng = np.random.default_rng(4)
        v64 = np.sort(rng.integers(0, 1 << 63, n, dtype=np.uint64))
        hi = (v64 >> 32).astype(np.uint32)
        lo = (v64 & 0xFFFFFFFF).astype(np.uint32)
        out = tpusort.sort_planes((jnp.asarray(hi), jnp.asarray(lo)),
                                  key_dtype="uint64", algorithm="msd")
        np.testing.assert_array_equal(np.asarray(out[0]), hi)
        np.testing.assert_array_equal(np.asarray(out[1]), lo)
        assert not calls


class TestTierCacheFlow:
    """r5 one-sync tiering: the tier-decision cache must never compromise
    correctness when the data distribution changes under a warm cache
    (the in-graph cond safety net owns exactness; the overlapped
    classification only re-routes FUTURE calls)."""

    def _patched(self, monkeypatch):
        from tpusort import api, planner

        monkeypatch.setattr(planner, "PLANNER_MIN_N", 1 << 10)
        api._TIER_CACHE.clear()
        return api

    def test_warm_cache_distribution_switch(self, monkeypatch):
        api = self._patched(monkeypatch)
        n = 20_000
        uni = datagen.random_keys(jax.random.key(11), n, "uint32")

        def run(k):
            return np.asarray(_with_cfg(CPU_CFG,
                                        lambda: tpusort.sort(k,
                                                             algorithm="msd")))

        # two uniform sorts warm the cache with tier=radix
        np.testing.assert_array_equal(run(uni), np_sort_oracle(np.asarray(uni)))
        np.testing.assert_array_equal(run(uni), np_sort_oracle(np.asarray(uni)))
        assert any(v["tier"] == "radix" and not v["presorted"]
                   for v in api._TIER_CACHE.values())
        # now constant keys of the SAME shape hit the warm radix cache:
        # the in-graph fallback must keep the output exact
        const = jnp.full((n,), jnp.uint32(3))
        np.testing.assert_array_equal(run(const), np.full(n, 3, np.uint32))
        # and the refreshed classification marks the class presorted
        # (constant keys ARE sorted), so the NEXT call short-circuits
        np.testing.assert_array_equal(run(const), np.full(n, 3, np.uint32))
        assert any(v["presorted"] for v in api._TIER_CACHE.values())

    def test_cache_key_separates_shapes(self, monkeypatch):
        api = self._patched(monkeypatch)
        a = datagen.random_keys(jax.random.key(12), 4096, "uint32")
        b = datagen.random_keys(jax.random.key(13), 8192, "uint32")

        def run(k):
            return np.asarray(_with_cfg(CPU_CFG,
                                        lambda: tpusort.sort(k,
                                                             algorithm="msd")))

        np.testing.assert_array_equal(run(a), np_sort_oracle(np.asarray(a)))
        np.testing.assert_array_equal(run(b), np_sort_oracle(np.asarray(b)))
        assert len({k[1] for k in api._TIER_CACHE}) == 2
