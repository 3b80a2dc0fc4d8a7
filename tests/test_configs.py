"""The tuning-config system must actually steer the planner (no dead
knobs).  Analog of the reference's per-(key,value)-size TPB/KPT tables
driving kernel launch shapes (``msb/src/sort/gpu_sort_config.h:146-207``)."""

import jax
import numpy as np
import pytest

import tpusort
from tpusort.configs import SortConfig, get_config, register_config
from tpusort.ops.msd import plan_msd
from tpusort.utils import datagen
from oracle import np_sort_oracle


def test_plan_follows_config_geometry():
    cfg_a = SortConfig(tile_elems=1 << 14, radix=32)
    cfg_b = SortConfig(tile_elems=2048, radix=16, s1=256)

    def kw(c):
        return {k: v for k, v in c.plan_kwargs().items() if k != "min_n"}

    pa = plan_msd(1 << 20, 0, 32, **kw(cfg_a))
    pb = plan_msd(1 << 20, 0, 32, **kw(cfg_b))
    assert pa is not None and pb is not None
    assert pa.passes[0].k == 1 << 14 and pa.passes[0].r == 32
    assert pb.passes[0].k == 2048 and pb.passes[0].r == 16
    assert pb.passes[0].s == 256
    assert (pa.passes, pa.seg) != (pb.passes, pb.seg)


def test_registered_config_changes_dispatch():
    """A high min_n registered for the current platform must force the msd
    engine into delegation; a low one must engage the pass pipeline.
    Verified through the public API (same input, same engine name)."""
    platform = jax.default_backend()
    n = 10_000
    keys = datagen.random_keys(jax.random.key(7), n, "uint32")
    want = np_sort_oracle(np.asarray(keys))
    saved = get_config(32, False)
    try:
        lo = SortConfig(tile_elems=2048, radix=16, s1=256, min_n=4096)
        register_config(32, False, platform, lo)
        plan = plan_msd(n, 0, 32, **{k: v for k, v in lo.plan_kwargs().items()
                                     if k != "min_n"})
        assert plan is not None, "low config must yield a plan at n=10k"
        got_lo = np.asarray(tpusort.sort(keys, algorithm="msd"))
        hi = SortConfig(min_n=1 << 20)
        register_config(32, False, platform, hi)
        got_hi = np.asarray(tpusort.sort(keys, algorithm="msd"))
    finally:
        register_config(32, False, platform, saved)
    np.testing.assert_array_equal(got_lo, want)
    np.testing.assert_array_equal(got_hi, want)


def test_small_n_threshold_steers_single_tile():
    """config.small_n_threshold bounds the single-sort "bitonic" engine:
    below it one unstable sort, above it the stable reference path —
    exact keys either way."""
    platform = jax.default_backend()
    n = 3000
    keys = datagen.random_keys(jax.random.key(9), n, "uint32")
    want = np_sort_oracle(np.asarray(keys))
    saved = get_config(32, False)
    try:
        register_config(32, False, platform,
                        SortConfig(small_n_threshold=1 << 14, min_n=1 << 16))
        a = np.asarray(tpusort.sort(keys, algorithm="bitonic"))
        register_config(32, False, platform,
                        SortConfig(small_n_threshold=128, min_n=1 << 16))
        b = np.asarray(tpusort.sort(keys, algorithm="bitonic"))
    finally:
        register_config(32, False, platform, saved)
    np.testing.assert_array_equal(a, want)
    np.testing.assert_array_equal(b, want)


def test_get_config_platform_fallback():
    saved = get_config(32, False, "weirdtpu")
    assert isinstance(saved, SortConfig)
    cfg = SortConfig(tile_elems=4096, radix=8)
    register_config(32, False, "*", cfg)
    try:
        assert get_config(32, False, "weirdtpu") == cfg
    finally:
        import tpusort.configs as _c

        _c._REGISTRY.pop((32, False, "*"), None)


@pytest.mark.parametrize("key_bits", [32, 64])
@pytest.mark.parametrize("has_values", [False, True])
def test_gpu_config_registered(key_bits, has_values):
    """The GPU has its own registered entry (not the unknown-platform
    fallback), and its auto engine is XLA's own sort."""
    from tpusort.configs import _REGISTRY

    assert (key_bits, has_values, "gpu") in _REGISTRY
    cfg = get_config(key_bits, has_values, "gpu")
    assert cfg.default_algorithm == "xla"


def test_auto_resolves_to_xla_engine_on_gpu_config():
    from tpusort import api
    from tpusort.ops.reference import sort_twiddled_reference

    cfg = get_config(32, False, "gpu")
    assert api._resolve_engine("auto", cfg) is sort_twiddled_reference
    assert api._resolve_engine("auto", cfg) is api._ENGINES["xla"]
    # auto never enters the host radix tier chain
    keys = jax.numpy.arange(8, dtype=jax.numpy.uint32)
    assert not api._host_tiered_applicable(keys, (), "auto", cfg)


def test_registry_platforms_are_cpu_and_gpu():
    from tpusort.configs import _REGISTRY

    assert {plat for (_, _, plat) in _REGISTRY} == {"cpu", "gpu"}
