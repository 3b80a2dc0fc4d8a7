"""Device facts derived at run time, and the compile-cache location."""

import os

import jax
import pytest

from tpusort.utils import device


def test_compile_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_defaults_into_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.compile_cache_dir()
    assert path == os.path.join(device.REPO_ROOT, ".jax_cache")
    assert os.path.isfile(os.path.join(os.path.dirname(path),
                                       "chip_smoke.py"))
    # the same path every time: it is part of the cache key
    assert device.compile_cache_dir() == path


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        assert device.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          saved[1])


@pytest.mark.parametrize("n,n_ops,limit,fits", [
    (1 << 29, 1, 16 * 2**30, True),
    (1 << 29, 2, 16 * 2**30, False),
    (1 << 30, 1, 60 * 2**30, True),
    (1 << 31, 1, 60 * 2**30, False),
])
def test_cond_fallback_bound_follows_memory(n, n_ops, limit, fits):
    assert device.cond_fallback_fits(n, n_ops, bytes_limit=limit) is fits


def test_cond_fallback_reads_device_limit(monkeypatch):
    monkeypatch.setattr(device, "device_bytes_limit", lambda: 1 << 20)
    n_fit = (1 << 20) // device.COND_BYTES_PER_ELEM_OP
    assert device.cond_fallback_fits(n_fit, 1)
    assert not device.cond_fallback_fits(n_fit + 1, 1)
    monkeypatch.setattr(device, "device_bytes_limit", lambda: None)
    assert device.cond_fallback_fits(1 << 40, 4)


def test_device_bytes_limit_cpu_has_none():
    # the CPU backend reports no memory stats: no bound applies
    if jax.default_backend() == "cpu":
        assert device.device_bytes_limit() is None


@pytest.mark.parametrize("fits", [True, False])
def test_msd_engine_uses_memory_bound(monkeypatch, fits):
    """Above the memory-derived bound the in-graph msd engine delegates to
    the reference sort (no lax.cond) instead of reserving a fallback the
    device cannot hold; below it the pipeline carries its cond."""
    import jax.numpy as jnp
    import numpy as np

    from tpusort.ops import msd

    monkeypatch.setattr(msd, "cond_fallback_fits", lambda n, n_ops: fits)
    keys = jnp.asarray(np.random.default_rng(0).integers(
        0, 2**32, 10_000, dtype=np.uint64).astype(np.uint32))
    small = dict(k=2048, r=8, s1=384, s=256, leaf_max=2048, min_n=1)

    def run(k):
        return msd.sort_twiddled_msd((k,), (), begin_bit=0, end_bit=32,
                                     total_bits=32, plan_kwargs=small)[0][0]

    assert ("cond[" in str(jax.make_jaxpr(run)(keys))) is fits
    np.testing.assert_array_equal(np.asarray(run(keys)),
                                  np.sort(np.asarray(keys)))
