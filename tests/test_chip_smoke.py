"""chip_smoke.py's checkers and guards, on CPU; its phases on a GPU.

The checkers decide whether a run on the card passes, so each must reject
the faults a broken sort produces: an unsorted output, a dropped (or
duplicated) key, a payload moved to another key, and, for stable sorts,
reordered equal keys.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusort.utils.checks import sort_checks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load_chip_smoke()


def _sorted_pairs(n=4096, seed=0, hi=64):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, hi, n).astype(np.uint32)        # many ties
    vals = np.arange(n, dtype=np.uint32)
    order = np.argsort(keys, kind="stable")
    return keys, vals, keys[order], vals[order]


def _check(ko, ki, vo=None, vi=None, stable=False):
    args = [jnp.asarray(ko), jnp.asarray(ki)]
    if vo is not None:
        args += [jnp.asarray(vo), jnp.asarray(vi)]
    return bool(jax.jit(sort_checks, static_argnames="stable")(
        *args, stable=stable))


def test_in_graph_checks_accept_correct_sort():
    ki, vi, ko, vo = _sorted_pairs()
    assert _check(ko, ki)
    assert _check(ko, ki, vo, vi, stable=True)


def _fault(kind, ko, vo):
    ko, vo = ko.copy(), vo.copy()
    if kind == "unsorted":
        ko[[10, 3000]] = ko[[3000, 10]]
        vo[[10, 3000]] = vo[[3000, 10]]
    elif kind == "dropped_key":
        # one key replaced by a copy of its neighbour: still sorted
        j = int(np.nonzero(ko[1:] != ko[:-1])[0][0]) + 1
        ko[j] = ko[j - 1]
    elif kind == "swapped_payload":
        j = int(np.nonzero(ko[1:] != ko[:-1])[0][0])
        vo[[j, j + 1]] = vo[[j + 1, j]]           # across different keys
    elif kind == "unstable":
        j = int(np.nonzero(ko[1:] == ko[:-1])[0][0])
        vo[[j, j + 1]] = vo[[j + 1, j]]           # within equal keys
    return ko, vo


@pytest.mark.parametrize("kind", ["unsorted", "dropped_key",
                                  "swapped_payload", "unstable"])
def test_in_graph_checks_reject(kind):
    ki, vi, ko, vo = _sorted_pairs(seed=1)
    bad_k, bad_v = _fault(kind, ko, vo)
    assert not _check(bad_k, ki, bad_v, vi, stable=True)
    if kind in ("unsorted", "dropped_key"):
        assert not _check(bad_k, ki)
    if kind == "unstable":
        # legal for an unstable sort: only the stable check rejects it
        assert _check(bad_k, ki, bad_v, vi, stable=False)


def test_in_graph_checks_two_planes():
    rng = np.random.default_rng(2)
    hi = rng.integers(0, 3, 2048).astype(np.uint32)
    lo = rng.integers(0, 2**32, 2048, dtype=np.uint64).astype(np.uint32)
    order = np.lexsort((lo, hi))
    out = (jnp.asarray(hi[order]), jnp.asarray(lo[order]))
    inp = (jnp.asarray(hi), jnp.asarray(lo))
    assert bool(sort_checks(out, inp))
    # lo plane detached from its hi plane: sorted, same plane sums
    lo_bad = lo[order].copy()
    j = int(np.nonzero(hi[order][1:] != hi[order][:-1])[0][0])
    lo_bad[[j, j + 1]] = lo_bad[[j + 1, j]]
    assert not bool(sort_checks((out[0], jnp.asarray(lo_bad)), inp))


@pytest.mark.parametrize("kind", ["unsorted", "dropped_key",
                                  "swapped_payload"])
def test_host_checkers_reject(kind):
    ki, vi, ko, vo = _sorted_pairs(seed=3)
    assert chip_smoke.exact_equal(ko, ko.copy())
    assert chip_smoke.rows_bound(ki, ko, np.argsort(ki, kind="stable"))
    bad_k, bad_v = _fault(kind, ko, vo)
    if kind == "swapped_payload":
        assert not chip_smoke.rows_bound(ki, ko, bad_v)
    else:
        assert not chip_smoke.exact_equal(bad_k, ko)
    # dtype is part of exactness
    assert not chip_smoke.exact_equal(ko.astype(np.int32), ko)


def test_refuses_to_run_off_gpu():
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu("cpu")
    chip_smoke.require_gpu("gpu")


def test_script_exits_nonzero_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "needs an NVIDIA GPU" in res.stderr


@pytest.mark.gpu
def test_chip_smoke_phases_small():
    """chip_smoke's one-card phases at reduced sizes (the script itself
    runs them at full size)."""
    smoke = chip_smoke.Smoke(iters=1)
    smoke.keys_full(1 << 20)
    smoke.pairs_full(1 << 20)
    smoke.skewed_full(1 << 20)
    smoke.argsort_nan(1 << 18)
    smoke.bit_range(1 << 18)
    smoke.wide_keys(1 << 18)
    smoke.segmented(1 << 18, 256, 8, 1 << 14)
    smoke.engines(1 << 18, 1 << 12)
